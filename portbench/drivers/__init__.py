"""General drivers, one a kind of traffic: a traffic file names its driver
(``"driver": "train"``) and gives its parameters.

A driver takes (cell, seed, device, tracer, fault) and has ``setup()``,
``run(seconds) -> Window``, ``release()`` (drop the port's state) and
``check() -> {number: value}`` (the comparison with the plain reference,
run after ``release``).  ``fault`` plants one of the faults the cell can
have (``FAULTS``), for the tests and the control runs only.

A driver module also declares ``span_metrics(traffic)``: the port's span
metrics (``port_spans.METRICS``) that a cell of that traffic reports,
each with whether every traced window reads it, the CPU's smoke windows
included (``True``), or only some (``False``).  ``port_spans`` lists a
metric's cells, and the span tests their expectations, from it alone.
"""
import dataclasses


@dataclasses.dataclass
class Window:
    attempted: int
    failed: int
    end_to_end: dict    # end-to-end metric name -> value
    readings: dict      # what the per-layer readers take from the driver
