"""Seeds derived from the run's ``--seed`` and a purpose, so that every
stream of a run (weights, images, geometries, samples) is fixed by the
seed and independent of the others."""
from __future__ import annotations

import numpy as np

# one tag per stream; a new stream takes a new number
WEIGHTS, IMAGES, GEOMETRY, ORDER, SAMPLE = range(5)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from the run's
    seed and the tags naming the stream."""
    state = np.random.SeedSequence([int(seed), *map(int, tags)])
    lo, hi = state.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for the stream named by ``tags``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         *map(int, tags)]))
