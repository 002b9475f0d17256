"""Deterministic procedural digits (offline MNIST stand-in), numpy.

A copy of ``synth_digits``, ``batch_iterator`` and their helpers from
``repro.data.synthetic``, so the port imports nothing of the JAX package;
tests/test_torch_train.py pins the arrays byte-equal to the reference's.
Pure functions of (seed, index): restarts are bitwise reproducible.

- ``synth_digits``: 10-class glyph dataset at 28x28. Classes are
  parametric stroke patterns (bars/crosses/rings/corners...) with
  per-sample jitter, thickness and noise.
- ``batch_iterator``: infinite shuffled batches, shardable across hosts.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, *idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *idx]))


# ---------------------------------------------------------------- digits ---
def _glyph(cls: int, r: np.random.Generator, size: int = 28) -> np.ndarray:
    img = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = size / 2 + r.uniform(-2, 2)
    cy = size / 2 + r.uniform(-2, 2)
    t = r.uniform(1.6, 2.8)  # stroke thickness
    s = size * r.uniform(0.28, 0.36)  # scale
    if cls == 0:  # ring
        rad = np.hypot(xx - cx, yy - cy)
        img[np.abs(rad - s) < t] = 1.0
    elif cls == 1:  # vertical bar
        img[(np.abs(xx - cx) < t) & (np.abs(yy - cy) < s * 1.3)] = 1.0
    elif cls == 2:  # horizontal bar
        img[(np.abs(yy - cy) < t) & (np.abs(xx - cx) < s * 1.3)] = 1.0
    elif cls == 3:  # cross
        img[(np.abs(xx - cx) < t) & (np.abs(yy - cy) < s)] = 1.0
        img[(np.abs(yy - cy) < t) & (np.abs(xx - cx) < s)] = 1.0
    elif cls == 4:  # diagonal
        img[(np.abs((xx - cx) - (yy - cy)) < t * 1.2)
            & (np.abs(xx - cx) < s) & (np.abs(yy - cy) < s)] = 1.0
    elif cls == 5:  # anti-diagonal
        img[(np.abs((xx - cx) + (yy - cy)) < t * 1.2)
            & (np.abs(xx - cx) < s) & (np.abs(yy - cy) < s)] = 1.0
    elif cls == 6:  # filled square
        img[(np.abs(xx - cx) < s * 0.7) & (np.abs(yy - cy) < s * 0.7)] = 1.0
    elif cls == 7:  # two dots (top/bottom)
        for dy in (-s, s):
            rad = np.hypot(xx - cx, yy - (cy + dy))
            img[rad < t * 1.8] = 1.0
    elif cls == 8:  # L corner
        img[(np.abs(xx - (cx - s * 0.8)) < t) & (np.abs(yy - cy) < s)] = 1.0
        img[(np.abs(yy - (cy + s * 0.8)) < t) & (np.abs(xx - cx) < s)] = 1.0
    else:  # 9: T shape
        img[(np.abs(yy - (cy - s * 0.8)) < t) & (np.abs(xx - cx) < s)] = 1.0
        img[(np.abs(xx - cx) < t) & (np.abs(yy - cy) < s)] = 1.0
    noise = r.uniform(0.0, 0.15, (size, size)).astype(np.float32)
    return np.clip(img + noise * (img == 0), 0.0, 1.0)


def synth_digits(
    num: int, seed: int = 0, size: int = 28, num_classes: int = 10,
    binarize: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (num, size, size) f32 in [0,1], labels (num,) i32)."""
    xs = np.empty((num, size, size), np.float32)
    ys = np.empty((num,), np.int32)
    for i in range(num):
        r = _rng(seed, i)
        cls = int(r.integers(0, num_classes))
        xs[i] = _glyph(cls, r, size)
        ys[i] = cls
    if binarize:
        xs = (xs > 0.5).astype(np.float32)
    return xs, ys


def batch_iterator(xs, ys, batch: int, seed: int = 0, host_id: int = 0,
                   num_hosts: int = 1):
    """Infinite shuffled batch iterator, shardable across hosts."""
    n = xs.shape[0]
    idx_host = np.arange(host_id, n, num_hosts)
    r = np.random.default_rng(seed + 1000 * host_id)
    while True:
        order = r.permutation(idx_host)
        for i in range(0, len(order) - batch + 1, batch):
            sel = order[i : i + batch]
            yield xs[sel], ys[sel]
