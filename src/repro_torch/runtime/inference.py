"""Deployment inference engine: frozen DONNs served on the card.

The port of ``repro.runtime.inference`` for the three DONN families:
classify (``"cls"``), RGB multi-channel (``"multi"``) and segmentation
with the optical skip (``"seg"``), on uniform and heterogeneous
(segmented-plan) stacks.

1.  **Frozen artifact** — ``freeze(model, params)`` resolves the codesign
    device response once and precomputes the ``gamma * exp(j theta)``
    modulation planes per layer (``frozen_modulation`` of the plan), in
    f32, bf16 or int8 storage.  Per-request work is then the FFT hops
    plus the hand-written kernels (``use_pallas``): two K1 passes per
    layer, K2 on the final hop (and on layer 0 under ``rfft_first``), K3
    for the detector readout (over the B*C channel rows for RGB; none for
    the segmentation family, which serves intensity maps).  Served
    outputs equal ``model.apply`` at eval bit for bit.
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

4.  **Artifacts** — ``runtime.resilience.save_deployed`` /
    ``load_deployed`` persist a deployment and cold-start it on the card;
    ``deployed_from_model`` takes the restored planes as they come off
    disk (moved to the deployment's device, storage dtype kept).
5.  **Over a mesh of ranks** — SPMD ``torch.distributed`` ranks
    (``sharding.make_mesh_2d``), every rank calling ``infer(x)`` with the
    same ``x`` and returning the whole outputs.  ``mesh_devices=k``:
    buckets of at least ``dp_min_bucket`` rows split over the ``data``
    ranks, each running the whole frozen forward (kernels included) on its
    rows with the planes replicated; the outputs are all-gathered.
    ``model_devices=k`` row-shards the frozen stacks, TF planes and
    detector masks over ``model`` (int8 scales replicated, as
    ``sharding.operand_pspec`` resolves them), every hop a pencil FFT
    (``pencil_fft.local_spectral_pair``), and sums the per-class partial
    readouts over ``model``: planes too large for one card, classify
    family, no kernels (the reference refuses ``use_pallas`` there).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import diffraction as df
from repro_torch.core import models as md
from repro_torch.core import propagation as pp
from repro_torch.core.laser import data_to_cplex, data_to_real
from repro_torch.data.pipeline import bucket_for, pad_batch
from repro_torch.device import resolve_device
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_gather_dim, all_reduce_sum
from repro_torch.runtime.resilience import (
    DeadlineExceededError,
    OverloadedError,
)
from repro_torch.tree import tree_map

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


# --------------------------------------------------------------------------
# Frozen deployment artifact
# --------------------------------------------------------------------------
class DeployedDONN:
    """A trained DONN frozen for serving.

    Holds the propagation plan, the precomputed modulation planes, the
    detector (``"cls"``, ``"multi"``) or the skip wiring (``"seg"``) —
    everything ``forward`` needs and nothing of the training machinery.
    Build with ``freeze(model, params)``.
    """

    def __init__(self, cfg, family: str, plan, frozen, source, in_n: int,
                 detector=None, skip_from=None, skip_hop=None,
                 out_grid=None, rfft_first: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.family = family  # "cls" | "multi" | "seg"
        self.plan = plan
        # restored planes arrive from disk: placed here, storage dtype kept
        self.frozen = tree_map(lambda t: torch.as_tensor(t).to(self.device),
                               tuple(frozen))
        self.source = torch.as_tensor(source).to(self.device)
        self.in_n = in_n
        self.detector = detector
        self.skip_from = skip_from
        self.skip_hop = skip_hop
        self.out_grid = out_grid
        self.heterogeneous = cfg.is_heterogeneous()
        # a segmented plan's frozen planes are one tuple per segment
        self.plane_dtype = pp.frozen_plane_dtype(
            self.frozen[0] if self.heterogeneous else self.frozen)
        self.rfft_first = bool(rfft_first)
        if self.rfft_first:
            if self.heterogeneous:
                raise ValueError(
                    "rfft_first covers uniform plans (the segmented first "
                    "hop is not ported, as in the reference)"
                )
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
        """Batched frozen forward: images (B, h, w) — (B, C, h, w) for
        RGB — to logits (B, K), or intensity maps (B, n, n) for ``"seg"``
        (the eval path: no train-time layer norm)."""
        frozen = self.frozen if frozen is None else frozen
        plan = self.plan
        if self.rfft_first:
            # real-to-complex entry: layer 0 runs as half-spectrum rFFTs
            xr = data_to_real(x, self.in_n) * self.source.real
            u = plan.first_layer_real(xr, frozen)
            start = 1
        else:
            u = data_to_cplex(x, self.in_n) * self.source
            start = 0
        if self.family == "seg":
            skip_u = None
            if self.skip_from is None:
                u = plan.forward(None, u, start=start, frozen=frozen)
            else:
                u = plan.forward(None, u, start=start,
                                 stop=self.skip_from + 1, frozen=frozen)
                skip_u = u
                u = plan.forward(None, u, start=self.skip_from + 1,
                                 frozen=frozen)
            return md.skip_combine(plan.propagate_final(u), skip_u,
                                   self.skip_hop, self.out_grid)
        u = plan.propagate_final(plan.forward(None, u, start=start,
                                              frozen=frozen))
        if self.family == "multi":
            return md.channel_readout(u, self.detector.masks_t,
                                      self.cfg.use_pallas)
        return self.detector(u)


def deployed_from_model(model, frozen, source=None,
                        rfft_first: bool = False) -> DeployedDONN:
    """Assemble a ``DeployedDONN`` around a built model + ready-made planes
    (plan, detector, grids and skip wiring from the model).

    ``freeze`` computes the planes from trained params;
    ``runtime.resilience.load_deployed`` restores them from an artifact
    (any storage dtype; int8 as 4-tuples) and ``source`` with them."""
    if isinstance(model, md.MultiChannelDONN):
        cm = model.channel_model
        return DeployedDONN(
            model.cfg, "multi", cm.plan, frozen,
            cm.source if source is None else source, cm.in_grid.n,
            detector=cm.detector, rfft_first=rfft_first, device=cm.device,
        )
    if isinstance(model, md.SegmentationDONN):
        return DeployedDONN(
            model.cfg, "seg", model.plan, frozen,
            model.source if source is None else source, model.in_grid.n,
            skip_from=model.skip_from, skip_hop=model.skip_hop,
            out_grid=model.grid, rfft_first=rfft_first, device=model.device,
        )
    if not isinstance(model, md.DONN):
        raise TypeError(f"cannot freeze {type(model).__name__}")
    return DeployedDONN(
        model.cfg, "cls", model.plan, frozen,
        model.source if source is None else source, model.in_grid.n,
        detector=model.detector, rfft_first=rfft_first, device=model.device,
    )


def freeze(model, params, plane_dtype: str = "float32",
           rfft_first: bool = False, device=None) -> DeployedDONN:
    """Fold a trained model + params into a serving artifact on ``device``.

    Covers the three families (classify, RGB, segmentation with the skip)
    on uniform and heterogeneous stacks.  ``device`` (the CUDA card by
    default) must be the model's: the artifact serves where the model's
    planes and detector live.
    ``plane_dtype`` is ``"float32"`` | ``"bfloat16"`` | ``"int8"`` storage
    (f32 accumulation); ``rfft_first`` opts into the half-spectrum
    real-to-complex first hop.
    """
    dev = resolve_device(device)
    if not isinstance(model, (md.DONN, md.MultiChannelDONN,
                              md.SegmentationDONN)):
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
    - ``donate`` is accepted for parity and has no effect;
    - ``mesh_devices`` x ``model_devices`` ranks (item 5 of the module
      docstring): every rank of the process group builds the engine and
      calls ``infer`` with the same requests.
    """

    def __init__(self, deployed: DeployedDONN,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 donate: bool = True, mesh_devices: Optional[int] = None,
                 dp_min_bucket: int = 8,
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
        self.dp_min_bucket = int(dp_min_bucket)
        self.ndev = int(mesh_devices) if mesh_devices else 1
        self.mp = int(model_devices) if model_devices else 1
        if self.ndev < 1 or self.mp < 1:
            raise ValueError("mesh_devices/model_devices must be >= 1")
        if self.ndev * self.mp > shd.world_size():
            raise ValueError(
                f"mesh needs {self.ndev * self.mp} ranks ({self.ndev} data x "
                f"{self.mp} model), have {shd.world_size()}"
            )
        if (self.ndev > 1 or self.mp > 1) and deployed.heterogeneous:
            raise NotImplementedError(
                "multi-device dispatch covers uniform plans (segmented "
                "frozen planes are a ragged tree)"
            )
        if self.mp > 1:
            _check_row_sharded(deployed, self.mp)
        self._mesh = None
        if self.ndev > 1 or self.mp > 1:
            self._mesh = shd.make_mesh_2d(self.ndev, self.mp,
                                          device=self.device)
            self._data_group = shd.axes_group(self._mesh, "data")
        if self.mp > 1:
            self._rows = _RowShards(deployed, self._mesh)
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0}

    def _x_ndim(self) -> int:
        return 4 if self.deployed.family == "multi" else 3

    def _example(self, bucket: int) -> np.ndarray:
        return np.zeros((bucket,) + expected_request_shape(self.deployed),
                        np.float32)

    def _dp(self, bucket: int) -> bool:
        return (self.ndev > 1 and bucket >= self.dp_min_bucket
                and bucket % self.ndev == 0)

    def _run(self, xp: np.ndarray) -> torch.Tensor:
        dp = self._dp(xp.shape[0])
        if dp:  # this data rank's rows of the bucket
            idx, count = shd.axes_index(self._mesh, "data")
            rows = xp.shape[0] // count
            xp = xp[idx * rows:(idx + 1) * rows]
        with tracing.span("serve.upload"):
            x = torch.from_numpy(np.ascontiguousarray(xp)).to(self.device)
        with tracing.span("serve.forward"):
            out = (self._rows.forward(x) if self.mp > 1
                   else self.deployed.forward(x))
        return all_gather_dim(out, self._data_group, 0) if dp else out

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

        ``x``: (B, h, w) images ((B, C, h, w) for RGB), any B; one request
        without its batch axis is taken as a batch of one.  Returns the
        (B, ...) outputs as numpy (the device-to-host copy is the
        response).
        """
        x = np.asarray(x)
        if x.ndim == self._x_ndim() - 1:
            x = x[None]
        b_max = self.buckets[-1]
        outs = []
        for lo in range(0, x.shape[0], b_max):
            chunk = x[lo: lo + b_max]
            bucket = bucket_for(chunk.shape[0], self.buckets)
            with tracing.span("serve.stack"):
                xp = pad_batch(chunk, bucket)
            out = self._run(xp)
            with tracing.span("serve.readback"):
                outs.append(out.cpu().numpy()[: chunk.shape[0]])
            self.stats["batches"] += 1
            self.stats["requests"] += int(chunk.shape[0])
            self.stats["padded_rows"] += bucket - int(chunk.shape[0])
        return np.concatenate(outs, axis=0)


def _check_row_sharded(deployed: DeployedDONN, k: int) -> None:
    """What row-sharded serving refuses, as the reference does."""
    cfg = deployed.cfg
    if deployed.family != "cls":
        raise NotImplementedError(
            "row-sharded serving covers the classify family; RGB and "
            "segmentation row-shard on the training path only "
            "(donn_steps.make_donn_sharded_loss)"
        )
    if deployed.rfft_first:
        raise NotImplementedError(
            "rfft_first's half-spectrum entry hop is not row-shardable; "
            "freeze with rfft_first=False to serve model-parallel"
        )
    if cfg.use_pallas:
        raise NotImplementedError(
            "the fused hand-written kernels operate on full planes"
        )
    if cfg.pad or any(l.approximation == "fraunhofer"
                      for l in cfg.resolved_layers()):
        raise NotImplementedError(
            "row-sharded serving needs unpadded angular-spectrum hops (the "
            "spectral-override contract, plan._hop)"
        )
    n = deployed.plan.grid.n
    if n % k:
        raise ValueError(f"field rows n={n} not divisible by "
                         f"model_devices={k}")


class _RowShards:
    """This rank's row blocks of a classify deployment's frozen planes, TF
    stacks and detector masks, and the frozen forward over them."""

    def __init__(self, deployed: DeployedDONN, mesh):
        from repro_torch.runtime.donn_steps import _plan_tf_stacks
        from repro_torch.runtime.pencil_fft import local_spectral_pair

        rules = shd.donn_rules()
        plane = ("layers", "field_h", "field_w")
        dev = deployed.device
        block = lambda t, spec: shd.local_block(  # noqa: E731
            torch.as_tensor(t), spec, mesh).to(dev).contiguous()
        self.deployed = deployed
        self.frozen = tuple(
            block(f, shd.operand_pspec(tuple(f.shape), plane, mesh, rules))
            for f in deployed.frozen)
        self.tfs = tuple(
            block(t, shd.operand_pspec(t.shape, plane, mesh, rules))
            for t in _plan_tf_stacks(deployed.plan))
        masks = deployed.detector.masks_t
        self.masks = block(masks, shd.operand_pspec(
            tuple(masks.shape), ("classes", "field_h", "field_w"), mesh,
            rules))
        self.mesh = mesh
        self.field = shd.rules_pspec((None, "field_h", "field_w"), rules,
                                     mesh)
        self.group = mesh.get_group("model")
        self.spectral = local_spectral_pair(self.group,
                                            shd.mesh_shape(mesh)["model"])

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dep, plan = self.deployed, self.deployed.plan
        u = shd.local_block(data_to_cplex(x, dep.in_n) * dep.source,
                            self.field, self.mesh)
        u = plan.forward(None, u, tfs=self.tfs, spectral=self.spectral,
                         frozen=self.frozen)
        u = plan.propagate_final(u, tfs=self.tfs, spectral=self.spectral)
        part = torch.einsum("...hw,chw->...c", df.intensity(u), self.masks)
        return all_reduce_sum(part, self.group)


def expected_request_shape(deployed: DeployedDONN) -> tuple:
    """Per-request input shape a deployment serves ((C, n, n) for RGB)."""
    cfg = deployed.cfg
    n = cfg.input_size
    if deployed.family == "multi":
        return (cfg.channels, n, n)
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

    __slots__ = ("x", "future", "t_arrival", "deadline", "id")

    def __init__(self, x, future, t_arrival, deadline, rid):
        self.x = x
        self.future = future
        self.t_arrival = t_arrival
        self.deadline = deadline  # absolute perf_counter time, or None
        self.id = rid  # the batcher's count of requests at its submit


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
            self.stats["submitted"] += 1
            self._pending.append(_Request(x, fut, now, deadline,
                                          self.stats["submitted"]))
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
            with tracing.span("serve.stack"):
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
        with tracing.span("serve.resolve"):
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
                with tracing.span("serve.batch", rows=len(group)) as batch:
                    if tracing.is_on():
                        self._record_queue(group, batch)
                    self._serve(group)
                with self._cv:
                    self._inflight = []

    def _record_queue(self, group: list, batch) -> None:
        """Each request's wait from its submit to its group's take."""
        taken = time.perf_counter_ns()
        batch.set(bucket=bucket_for(len(group), self.engine.buckets))
        for r in group:
            tracing.record("serve.queue", int(r.t_arrival * 1e9), taken,
                           parent=batch.id, request=r.id)

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
