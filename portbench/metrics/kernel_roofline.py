"""Share of their roofline that the port's hand-written kernels (K1-K3)
reach: the sum over every launch in the window of its bound (its bytes at
3.35 TB/s or its FLOPs at 67 TFLOP/s, the larger, at the launch's own
shapes: ``counts/kernels.py``) over the device time of those kernels.

An entry point is left out when the launches noted for it differ from
the port's own launch counter, or when no kernel of its name ran."""
from portbench.counts import peaks
from portbench.counts.kernels import ENTRY_POINTS


def read(trace, metric, cell):
    bound_s = device_s = 0.0
    for entry, (names, cost, counter) in ENTRY_POINTS.items():
        calls = trace.launches.get(entry, [])
        us = trace.kernel_us(names)
        if not calls or us <= 0.0 or len(calls) != trace.launch_counts.get(
                counter, -1):
            continue
        bound_s += sum(peaks.bound_s(*cost(shapes)) for shapes in calls)
        device_s += us * 1e-6
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
