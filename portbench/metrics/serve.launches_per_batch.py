"""CUDA launch calls a served batch makes: the launches the profiler
recorded inside ``serve.batch`` spans on the serving thread, over those
spans.  Only a card's trace records launch calls."""
from portbench.harness.spans import named


def read(trace, metric, cell):
    batches = named(trace, "serve.batch")
    launches = getattr(trace, "span_launches", {}).get("serve.batch", 0)
    if not batches or launches <= 0:
        return None
    return launches / len(batches)
