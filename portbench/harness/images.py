"""Synthetic digit-like inputs, made from the seed on the host.

Ten classes of stroke patterns (ring, bars, cross, diagonals, square,
dots, corner, T) with a jittered centre, size and stroke width, on a
faint noise floor.  Each image is an amplitude map scaled to carry the
same optical power, ``sum(x**2) == power``: a fixed laser power a
frame, which keeps the detector readings of every configuration in the
range where the softmax of the paper's loss is not saturated.
"""
from __future__ import annotations

import numpy as np

from portbench.harness import seeds

_CHUNK = 2048  # images made at once (bounds the temporaries)


def _strokes(cls, cx, cy, t, s, size: int) -> np.ndarray:
    """(m, size, size) bool masks of each image's class pattern."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    dx = xx[None] - cx[:, None, None]
    dy = yy[None] - cy[:, None, None]
    t = t[:, None, None]
    s = s[:, None, None]
    ax, ay = np.abs(dx), np.abs(dy)
    box = (ax < s) & (ay < s)
    patterns = [
        np.abs(np.hypot(dx, dy) - s) < t,                      # ring
        (ax < t) & (ay < 1.3 * s),                             # vertical bar
        (ay < t) & (ax < 1.3 * s),                             # horizontal bar
        ((ax < t) & (ay < s)) | ((ay < t) & (ax < s)),         # cross
        (np.abs(dx - dy) < 1.2 * t) & box,                     # diagonal
        (np.abs(dx + dy) < 1.2 * t) & box,                     # anti-diagonal
        (ax < 0.7 * s) & (ay < 0.7 * s),                       # square
        (np.hypot(dx, dy - s) < 1.8 * t)
        | (np.hypot(dx, dy + s) < 1.8 * t),                    # two dots
        ((np.abs(dx + 0.8 * s) < t) & (ay < s))
        | ((np.abs(dy - 0.8 * s) < t) & (ax < s)),             # L corner
        ((np.abs(dy + 0.8 * s) < t) & (ax < s))
        | ((ax < t) & (ay < s)),                               # T
    ]
    stack = np.stack(patterns)  # (10, m, size, size)
    return stack[cls % len(patterns), np.arange(len(cls))]


def glyphs(num: int, seed: int, stream: int = 0, size: int = 28,
           classes: int = 10, power: float = 1.0):
    """``num`` images (num, size, size) float32 and labels (num,) int64,
    a pure function of (seed, stream)."""
    r = seeds.rng(seed, seeds.IMAGES, stream)
    xs = np.empty((num, size, size), np.float32)
    ys = r.integers(0, classes, num).astype(np.int64)
    for lo in range(0, num, _CHUNK):
        m = min(_CHUNK, num - lo)
        cx, cy = size / 2 + r.uniform(-2.0, 2.0, (2, m))
        t = r.uniform(1.6, 2.8, m)
        s = size * r.uniform(0.28, 0.36, m)
        mask = _strokes(ys[lo:lo + m], cx, cy, t, s, size)
        floor = r.uniform(0.0, 0.15, (m, size, size))
        img = np.where(mask, 1.0, floor)
        norm = np.sqrt(np.sum(img * img, axis=(1, 2), keepdims=True))
        xs[lo:lo + m] = img * (np.sqrt(power) / norm)
    return xs, ys
