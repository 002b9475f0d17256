"""Milliseconds ``emulate_batch`` spends building a new candidate set's
stacked device inputs (the K plans and transfer planes, their stacks and
their uploads): the mean ``dse.inputs`` span whose cache lookup missed."""
from portbench.harness.spans import mean, ms, named


def read(trace, metric, cell):
    return mean(ms(s) for s in named(trace, "dse.inputs")
                if s.attrs.get("hit") is False)
