"""The window's model FLOPs (``counts/donn.py``, from the configuration's
shapes: three forwards a training sample) over the window's seconds at
the chip's peak in the precision the cell computes in: the driver's
``peak_flops`` reading where it hands one (``counts/peaks.py``), else
the float32 peak, which the DONN drivers compute at."""
from portbench.counts import peaks


def read(trace, metric, cell):
    flops = trace.readings.get("model_flops", 0.0)
    if flops <= 0.0 or trace.busy_s <= 0.0:
        return None
    peak = trace.readings.get("peak_flops", peaks.F32_FLOPS)
    return 100.0 * flops / (trace.window_s * peak)
