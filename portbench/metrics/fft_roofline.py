"""Share of its roofline that cuFFT reaches: the sum, over every
``torch.fft`` transform the port asked for in the window, of its bound
(the input read once and the output written once at 3.35 TB/s, or
5 N log2 N a complex transform at 67 TFLOP/s, the larger:
``counts/kernels.py``) over the device time of cuFFT's kernels.

Transforms that autograd runs in C++ (the backward of a plain
``torch.fft`` call, in training) are timed but not seen, so the share
reads that much low there."""
from portbench.counts import peaks
from portbench.counts.kernels import FFT_KERNELS, fft_cost


def read(trace, metric, cell):
    device_s = trace.kernel_us(FFT_KERNELS) * 1e-6
    if device_s <= 0.0 or not trace.ffts:
        return None
    bound_s = sum(peaks.bound_s(*fft_cost(fn, shape, dims))
                  for fn, shape, dims in trace.ffts)
    return 100.0 * bound_s / device_s
