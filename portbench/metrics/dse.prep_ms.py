"""Host milliseconds an ``emulate_batch`` call spends before it enqueues
its forward, once its set's inputs are built: the mean over calls whose
``dse.inputs`` hit the cache of ``dse.emulate`` less its ``dse.forward``
(the preparation, the codesign and the input upload)."""
from portbench.harness.spans import children, mean, ms, named


def read(trace, metric, cell):
    kids = children(trace)
    out = []
    for call in named(trace, "dse.emulate"):
        by = {k.name: k for k in kids[call.id]}
        inputs = by.get("dse.inputs")
        if inputs and inputs.attrs.get("hit") and "dse.forward" in by:
            out.append(ms(call) - ms(by["dse.forward"]))
    return mean(out)
