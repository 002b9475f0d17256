"""Batch shaping for bucketed serving (numpy, host side).

``bucket_for`` and ``pad_batch`` from ``repro.data.pipeline``.
"""
from __future__ import annotations

import numpy as np


def bucket_for(size: int, buckets) -> int:
    """Smallest serving bucket >= ``size`` (the largest bucket if none is).

    A request batch is padded up to the bucket it lands in, and batches
    larger than the biggest bucket are chunked by the caller
    (``repro_torch.runtime.inference.InferenceEngine``).
    """
    if size < 1:
        raise ValueError("bucket_for needs size >= 1")
    fitting = [b for b in buckets if b >= size]
    return min(fitting) if fitting else max(buckets)


def pad_batch(x: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad rows of ``x`` (B, ...) up to ``bucket`` rows (fresh buffer).

    Always returns a *new* host array — even when B == bucket — so the
    caller's request buffer is never the one uploaded and served.
    """
    x = np.asarray(x)
    if x.shape[0] > bucket:
        raise ValueError(f"batch of {x.shape[0]} does not fit bucket {bucket}")
    out = np.zeros((bucket,) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return out
