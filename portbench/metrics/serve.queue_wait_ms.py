"""Milliseconds a served request waited in ``MicroBatcher``'s queue, from
its submit to the take of its group: the mean of the window's
``serve.queue`` spans (the port's recorder, ``repro_torch.tracing``)."""
from portbench.harness.spans import mean, ms, named


def read(trace, metric, cell):
    return mean(ms(s) for s in named(trace, "serve.queue"))
