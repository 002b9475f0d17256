"""Deployment inference engine: frozen DONNs served on the card.

The port of ``repro.runtime.inference`` for the classify family:

1.  **Frozen artifact** — ``freeze(model, params)`` resolves the codesign
    device response once and precomputes the ``gamma * exp(j theta)``
    modulation planes per layer (``PropagationPlan.frozen_modulation``),
    in f32, bf16 or int8 storage.  Per-request work is then the FFT hops
    plus the hand-written kernels (``use_pallas``): two K1 passes per
    layer, K2 on the final hop (and on layer 0 under ``rfft_first``), K3
    for the detector readout.
2.  **Bucketed serving** — request batches pad to the nearest bucket
    (``repro_torch.data.pipeline``); ``warmup`` runs every bucket once at
    deploy time (kernel build, cuFFT plans), so the first request finds
    everything built.  ``donate`` is accepted and has no effect: the
    request is always copied into a fresh device buffer.
3.  **Micro-batching** — ``MicroBatcher`` queues single requests and
    launches on batch-full-or-deadline, with bounded admission
    (``OverloadedError``), per-request deadlines
    (``DeadlineExceededError``), submit-time validation and group
    bisection.

Multi-device dispatch (``mesh_devices``/``model_devices`` above 1), the
RGB and segmentation families and serialized artifacts come with later
slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import propagation as pp
from repro_torch.core.laser import data_to_cplex, data_to_real
from repro_torch.core.models import DONN
from repro_torch.data.pipeline import bucket_for, pad_batch
from repro_torch.device import resolve_device
from repro_torch.runtime.resilience import (
    DeadlineExceededError,
    OverloadedError,
)

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


# --------------------------------------------------------------------------
# Frozen deployment artifact
# --------------------------------------------------------------------------
class DeployedDONN:
    """A trained DONN frozen for serving (classify family).

    Holds the propagation plan, the precomputed modulation planes and the
    detector — everything ``forward`` needs and nothing of the training
    machinery.  Build with ``freeze(model, params)``.
    """

    def __init__(self, cfg, family: str, plan, frozen, source, in_n: int,
                 detector=None, rfft_first: bool = False, device=None):
        if family != "cls":
            raise NotImplementedError(
                f"the {family!r} family comes with the RGB/segmentation slice"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.family = family
        self.plan = plan
        self.frozen = tuple(frozen)
        self.source = torch.as_tensor(source).to(self.device)
        self.in_n = in_n
        self.detector = detector
        self.plane_dtype = pp.frozen_plane_dtype(self.frozen)
        self.rfft_first = bool(rfft_first)
        if self.rfft_first:
            if not plan.rfft_first_supported():
                raise ValueError(
                    "rfft_first needs an unpadded non-fraunhofer plan"
                )
            if plan.depth < 1:
                raise ValueError("rfft_first needs at least one layer")
            if not torch.all(self.source.imag == 0.0):
                raise ValueError(
                    "rfft_first needs a real source field (amplitude-"
                    "encoded inputs keep the entry field real)"
                )
            # half-spectrum TF planes build (and evenness-check) eagerly
            plan._rfft_half(self.device)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, frozen=None) -> torch.Tensor:
        """Batched frozen forward: images (B, h, w) -> logits (B, C)."""
        frozen = self.frozen if frozen is None else frozen
        if self.rfft_first:
            # real-to-complex entry: layer 0 runs as half-spectrum rFFTs
            xr = data_to_real(x, self.in_n) * self.source.real
            u = self.plan.first_layer_real(xr, frozen)
            start = 1
        else:
            u = data_to_cplex(x, self.in_n) * self.source
            start = 0
        u = self.plan.forward(None, u, start=start, frozen=frozen)
        u = self.plan.propagate_final(u)
        return self.detector(u)


def deployed_from_model(model, frozen, source=None,
                        rfft_first: bool = False) -> DeployedDONN:
    """Assemble a ``DeployedDONN`` around a built model + ready-made planes."""
    if not isinstance(model, DONN):
        raise TypeError(f"cannot freeze {type(model).__name__}")
    return DeployedDONN(
        model.cfg, "cls", model.plan, frozen,
        model.source if source is None else source, model.in_grid.n,
        detector=model.detector, rfft_first=rfft_first, device=model.device,
    )


def freeze(model, params, plane_dtype: str = "float32",
           rfft_first: bool = False, device=None) -> DeployedDONN:
    """Fold a trained model + params into a serving artifact on ``device``.

    ``device`` (the CUDA card by default) must be the model's: the
    artifact serves where the model's planes and detector live.
    ``plane_dtype`` is ``"float32"`` | ``"bfloat16"`` | ``"int8"`` storage
    (f32 accumulation); ``rfft_first`` opts into the half-spectrum
    real-to-complex first hop.
    """
    dev = resolve_device(device)
    if not isinstance(model, DONN):
        raise TypeError(f"cannot freeze {type(model).__name__}")
    if model.device != dev:
        raise ValueError(
            f"model lives on {model.device}, freeze asked for {dev}"
        )
    frozen = model.plan.frozen_modulation(model.stacked_phases(params),
                                          plane_dtype)
    return deployed_from_model(model, frozen, rfft_first=rfft_first)


# --------------------------------------------------------------------------
# Bucketed serving engine
# --------------------------------------------------------------------------
class InferenceEngine:
    """Shape-bucketed serving around a ``DeployedDONN`` on ``device``.

    - a request batch pads to the smallest bucket that holds it; batches
      wider than the largest bucket chunk through it;
    - ``warmup()`` runs every bucket once at deploy time;
    - ``donate`` is accepted for parity and has no effect.
    """

    def __init__(self, deployed: DeployedDONN,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 donate: bool = True, mesh_devices: Optional[int] = None,
                 model_devices: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        if deployed.device != self.device:
            raise ValueError(
                f"deployment lives on {deployed.device}, engine asked for "
                f"{self.device}"
            )
        self.deployed = deployed
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        self.donate = donate
        self.ndev = int(mesh_devices) if mesh_devices else 1
        self.mp = int(model_devices) if model_devices else 1
        if self.ndev < 1 or self.mp < 1:
            raise ValueError("mesh_devices/model_devices must be >= 1")
        if self.ndev > 1 or self.mp > 1:
            raise NotImplementedError(
                "multi-device serving (mesh_devices/model_devices > 1) "
                "comes with the multi-device slice"
            )
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0}

    def _example(self, bucket: int) -> np.ndarray:
        n = self.deployed.cfg.input_size
        return np.zeros((bucket, n, n), np.float32)

    def _run(self, xp: np.ndarray) -> torch.Tensor:
        return self.deployed.forward(torch.from_numpy(xp).to(self.device))

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Run every bucket once now (kernel build, FFT plans).

        Deploy-time cost instead of first-request latency.  Returns
        {bucket: seconds}.
        """
        out = {}
        for b in (self.buckets if buckets is None else buckets):
            t0 = time.perf_counter()
            self._run(self._example(b)).cpu()
            out[b] = time.perf_counter() - t0
        return out

    def infer(self, x) -> np.ndarray:
        """Serve one request batch: pad to bucket, run, slice.

        ``x``: (B, h, w) images, any B.  Returns the (B, C) outputs as
        numpy (the device-to-host copy is the response).
        """
        x = np.asarray(x)
        if x.ndim == 2:
            x = x[None]
        b_max = self.buckets[-1]
        outs = []
        for lo in range(0, x.shape[0], b_max):
            chunk = x[lo: lo + b_max]
            bucket = bucket_for(chunk.shape[0], self.buckets)
            out = self._run(pad_batch(chunk, bucket))
            outs.append(out.cpu().numpy()[: chunk.shape[0]])
            self.stats["batches"] += 1
            self.stats["requests"] += int(chunk.shape[0])
            self.stats["padded_rows"] += bucket - int(chunk.shape[0])
        return np.concatenate(outs, axis=0)


def expected_request_shape(deployed: DeployedDONN) -> tuple:
    """Per-request input shape a deployment serves."""
    n = deployed.cfg.input_size
    return (n, n)


def validate_request(deployed: DeployedDONN, x: np.ndarray) -> None:
    """Admission-time request validation.

    Raises ``TypeError``/``ValueError`` on a request that could poison a
    batch (wrong dtype kind / per-request shape).
    """
    if not (np.issubdtype(x.dtype, np.floating)
            or np.issubdtype(x.dtype, np.integer)
            or np.issubdtype(x.dtype, np.bool_)):
        raise TypeError(
            f"request dtype {x.dtype} is not castable to float32"
        )
    exp = expected_request_shape(deployed)
    if x.shape != exp:
        raise ValueError(
            f"request shape {x.shape} != expected per-request shape "
            f"{exp} for the {deployed.family!r} family"
        )


class _Request:
    """One queued inference request (slots: this sits on the hot path)."""

    __slots__ = ("x", "future", "t_arrival", "deadline")

    def __init__(self, x, future, t_arrival, deadline):
        self.x = x
        self.future = future
        self.t_arrival = t_arrival
        self.deadline = deadline  # absolute perf_counter time, or None


class MicroBatcher:
    """Batch-full-or-deadline request dispatcher over an ``InferenceEngine``.

    ``submit(x)`` enqueues one request and returns a
    ``concurrent.futures.Future``; a background worker drains the queue
    whenever the largest bucket fills or the oldest queued request has
    waited ``max_wait_ms``, pads the group to the nearest bucket and
    serves it as one device call.

    - **bounded admission** — at most ``max_queue`` requests wait; beyond
      that ``submit`` sheds with ``OverloadedError``;
    - **per-request deadlines** — ``submit(x, timeout_ms=...)`` fails the
      future with ``DeadlineExceededError`` once the deadline passes
      undispatched;
    - **submit-time validation** — shape/dtype mismatches are rejected at
      the door (``validate=False`` trusts the caller);
    - **group bisection** — a group that fails to serve is split in half
      and retried, so one poison request fails only its own future;
    - **accounted shutdown** — ``close()`` returns True for a clean drain;
      on an unclean join it fails every unresolved future and returns
      False.
    """

    def __init__(self, engine: InferenceEngine, max_wait_ms: float = 2.0,
                 max_queue: Optional[int] = 1024, validate: bool = True):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = None if not max_queue else int(max_queue)
        self.validate = validate
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list = []  # [_Request]
        self._inflight: list = []  # group currently being served
        self._closed = False
        self.stats = {"submitted": 0, "served": 0, "shed": 0, "expired": 0,
                      "failed": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # --- admission ---
    def submit(self, x, timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to its output.

        Raises ``OverloadedError`` when the admission queue is full and
        ``ValueError``/``TypeError`` on malformed requests when
        ``validate`` is on.  With ``timeout_ms`` set, the future fails
        with ``DeadlineExceededError`` if still undispatched then.
        """
        x = np.asarray(x)
        if self.validate:
            validate_request(self.engine.deployed, x)
        now = time.perf_counter()
        deadline = None if timeout_ms is None else now + timeout_ms / 1e3
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_queue is not None
                    and len(self._pending) >= self.max_queue):
                self.stats["shed"] += 1
                raise OverloadedError(
                    f"admission queue full ({self.max_queue} pending)"
                )
            self._pending.append(_Request(x, fut, now, deadline))
            self.stats["submitted"] += 1
            self._cv.notify()
        return fut

    # --- dispatch ---
    def _split_expired(self, now: float) -> list:
        """Pop expired requests off the queue (caller holds the lock)."""
        expired = [r for r in self._pending
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            self._pending = [r for r in self._pending if r not in expired]
        return expired

    def _take(self) -> tuple:
        """Block until work is ready: (group_to_serve, expired_requests).

        Both empty means the batcher is closed and drained.
        """
        b_max = self.engine.buckets[-1]
        with self._cv:
            while True:
                now = time.perf_counter()
                expired = self._split_expired(now)
                if expired:
                    return [], expired
                if self._closed and not self._pending:
                    return [], []
                if self._pending:
                    if len(self._pending) >= b_max or self._closed:
                        break
                    timeout = self.max_wait_s - (now - self._pending[0].t_arrival)
                    dls = [r.deadline for r in self._pending
                           if r.deadline is not None]
                    if dls:
                        timeout = min(timeout, min(dls) - now)
                    if timeout <= 0:
                        break
                    self._cv.wait(timeout=timeout)
                else:
                    self._cv.wait(timeout=0.1)
            group = self._pending[:b_max]
            del self._pending[:len(group)]
            self._inflight = group
            return group, []

    def _serve(self, group: list):
        """Serve a group; on failure bisect so only poison requests fail."""
        try:
            # the stack is inside the try: a malformed request (validate
            # off) must fail its future, not kill the worker
            xs = np.stack([r.x for r in group])
            outs = self.engine.infer(xs)
        except Exception as e:  # noqa: BLE001 - propagate to callers
            if len(group) == 1:
                if not group[0].future.done():
                    group[0].future.set_exception(e)
                self.stats["failed"] += 1
                return
            mid = len(group) // 2
            self._serve(group[:mid])
            self._serve(group[mid:])
            return
        for r, out in zip(group, outs):
            if not r.future.done():
                r.future.set_result(out)
            self.stats["served"] += 1

    def _run(self):
        while True:
            group, expired = self._take()
            for r in expired:
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        "request deadline expired before dispatch"
                    ))
                self.stats["expired"] += 1
            if not group and not expired:
                return
            if group:
                self._serve(group)
                with self._cv:
                    self._inflight = []

    def close(self, timeout: float = 30.0) -> bool:
        """Drain the queue and stop the worker.

        Returns True on a clean drain.  If the worker fails to join within
        ``timeout`` seconds, every unresolved pending/in-flight future is
        failed with a ``RuntimeError`` and False is returned.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        if not self._worker.is_alive():
            return True
        with self._cv:
            stranded = self._pending + self._inflight
            self._pending = []
        err = RuntimeError(
            f"MicroBatcher shutdown unclean: worker did not join within "
            f"{timeout}s; {len(stranded)} request(s) abandoned"
        )
        for r in stranded:
            if not r.future.done():
                r.future.set_exception(err)
        return False
