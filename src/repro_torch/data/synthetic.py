"""Deterministic procedural digits (offline MNIST stand-in), numpy.

A copy of ``synth_digits``, ``synth_rgb_scenes``, ``synth_seg``,
``synth_tokens``, ``token_batch_iterator``, ``batch_iterator`` and their
helpers from ``repro.data.synthetic``, so the port imports nothing of the
JAX package; tests/test_torch_train.py, tests/test_torch_families.py and
tests/test_torch_lm_train.py pin the arrays byte-equal to the
reference's.  Pure functions of (seed, index): restarts are bitwise
reproducible.

- ``synth_digits``: 10-class glyph dataset at 28x28. Classes are
  parametric stroke patterns (bars/crosses/rings/corners...) with
  per-sample jitter, thickness and noise.
- ``synth_rgb_scenes``: 6-class RGB compositions (the RGB DONN, Fig. 12).
- ``synth_seg``: gray scenes with binary "building" masks (the
  segmentation DONN, Fig. 13).
- ``synth_tokens`` / ``token_batch_iterator``: a Zipfian token stream
  with a planted bigram process, and its infinite next-token batches
  (the LM training launcher's data; a resume replays it).
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


# ------------------------------------------------------------ rgb scenes ---
def synth_rgb_scenes(
    num: int, seed: int = 0, size: int = 64, num_classes: int = 6
) -> tuple[np.ndarray, np.ndarray]:
    """(num, 3, size, size) RGB compositions; class = dominant layout/palette."""
    xs = np.empty((num, 3, size, size), np.float32)
    ys = np.empty((num,), np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(num):
        r = _rng(seed, i, 7)
        cls = int(r.integers(0, num_classes))
        base = r.uniform(0.05, 0.2, (3, 1, 1)).astype(np.float32)
        img = np.broadcast_to(base, (3, size, size)).copy()
        ch = cls % 3  # dominant channel
        if cls < 3:  # horizon split (sky/ground)
            h = r.uniform(0.3, 0.7)
            img[ch] += (yy < h) * r.uniform(0.5, 0.9)
            img[(ch + 1) % 3] += (yy >= h) * r.uniform(0.3, 0.6)
        else:  # radial blob scene
            cx, cy = r.uniform(0.3, 0.7, 2)
            rad = np.hypot(xx - cx, yy - cy)
            img[ch] += np.exp(-(rad**2) / r.uniform(0.02, 0.08))
        img += r.uniform(0, 0.08, img.shape).astype(np.float32)
        xs[i] = np.clip(img, 0, 1)
        ys[i] = cls
    return xs, ys


# ---------------------------------------------------------- segmentation ---
def synth_seg(
    num: int, seed: int = 0, size: int = 64
) -> tuple[np.ndarray, np.ndarray]:
    """(num, size, size) gray scenes + binary 'building' masks (num,size,size)."""
    xs = np.empty((num, size, size), np.float32)
    ms = np.empty((num, size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(num):
        r = _rng(seed, i, 13)
        img = r.uniform(0.0, 0.25, (size, size)).astype(np.float32)
        mask = np.zeros((size, size), np.float32)
        for _ in range(int(r.integers(1, 4))):  # rectangular "buildings"
            w = int(r.integers(size // 8, size // 3))
            h = int(r.integers(size // 6, size // 2))
            x0 = int(r.integers(0, size - w))
            y0 = int(r.integers(size // 4, size - h))
            img[y0 : y0 + h, x0 : x0 + w] = r.uniform(0.6, 1.0)
            mask[y0 : y0 + h, x0 : x0 + w] = 1.0
        # distractor circles (bright but NOT buildings)
        for _ in range(int(r.integers(0, 3))):
            cx, cy = r.integers(0, size, 2)
            rad = int(r.integers(2, size // 10))
            circ = (xx - cx) ** 2 + (yy - cy) ** 2 < rad * rad
            img[circ] = r.uniform(0.5, 0.9)
        xs[i] = np.clip(img, 0, 1)
        ms[i] = mask
    return xs, ms


# ------------------------------------------------------------ lm tokens ---
def synth_tokens(
    num_seqs: int, seq_len: int, vocab: int, seed: int = 0,
    bigram_frac: float = 0.75,
) -> np.ndarray:
    """Deterministic Zipfian token stream with a planted bigram process.

    ~bigram_frac of transitions follow a fixed random bigram table (so a
    model can visibly reduce loss in a few hundred steps); the rest are
    Zipf-distributed noise.  Pure function of (seed, indices).
    """
    r = np.random.default_rng(np.random.SeedSequence([seed, 17]))
    table = r.integers(0, vocab, size=vocab)  # planted bigram successor
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    zipf_p = (1.0 / ranks) / np.sum(1.0 / ranks)
    out = np.empty((num_seqs, seq_len), np.int32)
    for i in range(num_seqs):
        rr = np.random.default_rng(np.random.SeedSequence([seed, 23, i]))
        toks = np.empty(seq_len, np.int32)
        toks[0] = rr.integers(0, vocab)
        noise = rr.choice(vocab, size=seq_len, p=zipf_p)
        use_bigram = rr.random(seq_len) < bigram_frac
        for t in range(1, seq_len):
            toks[t] = table[toks[t - 1]] if use_bigram[t] else noise[t]
        out[i] = toks
    return out


def token_batch_iterator(batch: int, seq_len: int, vocab: int, seed: int = 0,
                         host_id: int = 0, num_hosts: int = 1):
    """Infinite {"tokens", "labels"} batches; labels = next-token shift."""
    i = host_id
    while True:
        seqs = np.stack([
            synth_tokens(1, seq_len + 1, vocab, seed=seed + 7919 * (i + j))[0]
            for j in range(0, batch * num_hosts, num_hosts)
        ])
        yield {"tokens": seqs[:, :-1].astype(np.int32),
               "labels": seqs[:, 1:].astype(np.int32)}
        i += batch * num_hosts


# ------------------------------------------------------------- iterators ---
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
