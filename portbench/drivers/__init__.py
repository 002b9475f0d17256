"""General drivers, one a kind of traffic: a traffic file names its driver
(``"driver": "train"``) and gives its parameters.

A driver takes (cell, seed, device, tracer, fault) and has ``setup()``,
``run(seconds) -> Window``, ``release()`` (drop the port's state) and
``check() -> {number: value}`` (the comparison with the plain reference,
run after ``release``).  ``fault`` plants one of the faults the cell can
have (``FAULTS``), for the tests and the control runs only.
"""
import dataclasses


@dataclasses.dataclass
class Window:
    attempted: int
    failed: int
    end_to_end: dict    # end-to-end metric name -> value
    readings: dict      # what the per-layer readers take from the driver
