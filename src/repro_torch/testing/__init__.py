"""Test-support package: fault injectors for resilience testing.

It ships in ``src`` so that ``chip_smoke.py``'s persistence phase and
operators' drills use the same injectors the tests do; nothing in the
serving or training paths imports it.
"""
from repro_torch.testing.faults import (
    CrashingEngine,
    FlakyEngine,
    SlowEngine,
    corrupt_chunk,
    flip_crc,
    kill_replica,
    perturb_frozen,
    poison_batches,
)

__all__ = [
    "CrashingEngine",
    "FlakyEngine",
    "SlowEngine",
    "corrupt_chunk",
    "flip_crc",
    "kill_replica",
    "perturb_frozen",
    "poison_batches",
]
