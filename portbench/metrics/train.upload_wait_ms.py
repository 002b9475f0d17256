"""Milliseconds a training step's feed spends in the pageable copy of its
chunk to the device, which waits for the device work queued before it:
each ``train.chunk`` span's ``train.upload`` child over the chunk's
steps, the mean over the window's chunks.  The rest of
``train.dispatch_ms`` is the enqueue of the steps."""
from portbench.harness.spans import children, mean, ms, named


def read(trace, metric, cell):
    kids = children(trace)
    return mean(sum(ms(k) for k in kids[c.id] if k.name == "train.upload")
                / c.attrs["steps"] for c in named(trace, "train.chunk"))
