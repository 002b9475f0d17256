"""Host milliseconds a served batch spends with nothing of its own queued
on the device: the mean over the window's ``serve.batch`` spans of their
time outside their ``serve.forward`` (the enqueue) and ``serve.readback``
(the wait for the device) children.  It is the stack, the upload, the
futures and their callbacks: work the device waits for."""
from portbench.harness.spans import children, mean, ms, named

DEVICE_SIDE = ("serve.forward", "serve.readback")


def read(trace, metric, cell):
    kids = children(trace)
    return mean(ms(b) - sum(ms(k) for k in kids[b.id]
                            if k.name in DEVICE_SIDE)
                for b in named(trace, "serve.batch"))
