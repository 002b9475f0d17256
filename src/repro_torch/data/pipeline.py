"""Data pipeline runtime: background and device prefetch, batch shaping.

The port of ``repro.data.pipeline``:

- ``Prefetcher``: a worker thread keeps a bounded queue of ready batches
  (host-side overlap); backpressure via the queue bound.  The LM training
  launcher (``repro_torch.launch.train``) feeds its steps through one,
  with the host-to-device copy as its transform.
- ``device_prefetch``: keeps up to ``size`` batches in flight to the
  device, so the upload of batch k+1 overlaps the step consuming batch k
  (the feeder of the chunked training driver).
- ``stack_batches``: groups per-step batches into stacked ``(S, B, ...)``
  chunks for ``repro_torch.core.train_utils.make_train_chunk``.
- ``bucket_for`` / ``pad_batch``: shape bucketing for serving
  (``repro_torch.runtime.inference``).
- ``StepMonitor``: EMA step-time tracker that flags straggling steps
  (z-score over a rolling window), as the reference's.
"""
from __future__ import annotations

import collections
import math
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


class Prefetcher:
    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._transform = transform
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised by __next__
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def device_prefetch(it: Iterator, size: int = 2, device=None):
    """Keep up to ``size`` batches of ``it`` in flight to ``device``.

    Every leaf (numpy array or tensor) is uploaded to ``device`` (the CUDA
    card unless named).  On the card the host copy is pinned and the upload
    is non-blocking, issued from the consumer's thread on its current
    stream, so the steps that read the batch are ordered after it on that
    stream; each batch gets its own pinned buffer, which PyTorch's caching
    host allocator does not hand out again before the copy reading it has
    finished.  Yields the same trees as ``it`` with tensor leaves.
    """
    if size < 1:
        raise ValueError("device_prefetch needs size >= 1")
    dev = resolve_device(device)
    pin = dev.type == "cuda"

    def put(leaf):
        t = torch.as_tensor(leaf)
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=pin)

    buf: collections.deque = collections.deque()
    for item in it:
        buf.append(tree_map(put, item))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def stack_batches(it: Iterator, steps_per_call: int,
                  total: Optional[int] = None):
    """Group per-step batches into stacked ``(S, B, ...)`` chunk trees.

    Pulls up to ``total`` batches from ``it`` (all of them when ``None``)
    and yields trees whose numpy leaves gained a leading chunk axis of
    length ``steps_per_call`` (the final chunk may be shorter).
    """
    if steps_per_call < 1:
        raise ValueError("stack_batches needs steps_per_call >= 1")
    chunk: list = []
    pulled = 0
    for batch in it:
        chunk.append(batch)
        pulled += 1
        if len(chunk) == steps_per_call:
            yield tree_map(lambda *xs: np.stack(xs), *chunk)
            chunk = []
        if total is not None and pulled >= total:
            break
    if chunk:
        yield tree_map(lambda *xs: np.stack(xs), *chunk)


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


class StepMonitor:
    """EMA + rolling z-score step-time tracker with straggler flags."""

    def __init__(self, alpha: float = 0.1, window: int = 50,
                 z_thresh: float = 3.0):
        self.alpha = alpha
        self.z_thresh = z_thresh
        self.ema: Optional[float] = None
        self.history: collections.deque = collections.deque(maxlen=window)
        self.stragglers: list = []
        self._t0: Optional[float] = None
        self.steps = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: Optional[int] = None) -> float:
        dt = time.perf_counter() - self._t0
        self.record(dt, step)
        return dt

    def record(self, dt: float, step: Optional[int] = None):
        self.steps += 1
        if self.ema is None:
            self.ema = dt
        if len(self.history) >= 5:
            mu = sum(self.history) / len(self.history)
            var = sum((x - mu) ** 2 for x in self.history) / len(self.history)
            sd = math.sqrt(max(var, 1e-12))
            if dt > mu + self.z_thresh * sd:
                self.stragglers.append(
                    {"step": step if step is not None else self.steps,
                     "dt": dt, "mean": mu, "z": (dt - mu) / sd}
                )
        self.history.append(dt)
        self.ema = (1 - self.alpha) * self.ema + self.alpha * dt

    @property
    def straggler_fraction(self) -> float:
        return len(self.stragglers) / max(self.steps, 1)
