"""The window's model FLOPs (``counts/donn.py``, from the configuration's
shapes: three forwards a training sample) over the window's seconds at
the chip's float32 peak."""
from portbench.counts import peaks


def read(trace, metric, cell):
    flops = trace.readings.get("model_flops", 0.0)
    if flops <= 0.0 or trace.busy_s <= 0.0:
        return None
    return 100.0 * flops / (trace.window_s * peaks.F32_FLOPS)
