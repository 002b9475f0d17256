"""Serving resilience: serialized artifacts and engine supervision.

The port of ``repro.runtime.resilience``:

1.  **Serialized frozen artifacts** — ``save_deployed(deployed, dir)``
    persists what serving needs: the architecture as a JSON spec
    (``dsl.to_spec``), the frozen modulation planes and the resolved
    source field through the integrity-checked ``checkpoint.store``
    (atomic commit, per-chunk crc32).  ``load_deployed(dir)`` cold-starts
    a ``DeployedDONN`` on the card from disk with no training state, and
    serves outputs bit-identical to the deployment that was saved.  The
    format is the reference's (format 2), so the port serves artifacts the
    JAX package wrote and the JAX package serves the port's.  The plane
    convention travels with the spec: ``use_pallas`` artifacts hold polar
    ``(theta, amp)`` planes, the others cartesian ``(mr, mi)``, int8 ones
    4-tuples with per-layer scales.
2.  **Typed serving failures** — ``OverloadedError``,
    ``DeadlineExceededError`` (the micro-batcher), ``DrainingError`` and
    ``RetriesExhaustedError`` (the fleet, ``runtime.fleet``).
3.  **Engine supervision** — ``EngineSupervisor`` owns an engine built
    from a serialized artifact, health-checks it, restarts it from the
    artifact when it fails (bounded budget, exponential backoff with
    jitter) and reports readiness and error-rate stats.

Every entry point that places tensors (``load_deployed``,
``EngineSupervisor``) runs on the CUDA card unless the caller names
another device; without a card it raises.
"""
from __future__ import annotations

import json
import os
import pathlib
import random
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.device import resolve_device

# Format history (the reference's):
#   1 — f32 modulation plane pairs only.
#   2 — adds "plane_dtype" (float32 | bfloat16 | int8 frozen-plane storage;
#       int8 planes are 4-tuples with per-layer scales) and "rfft_first"
#       (half-spectrum real entry hop).  Format-1 artifacts still load
#       (their planes are implicitly float32 pairs); unknown formats are
#       rejected before any deserialization.
ARTIFACT_FORMAT = 2
KNOWN_FORMATS = (1, 2)
ARTIFACT_FILE = "ARTIFACT.json"
PLANES_DIR = "planes"


class OverloadedError(RuntimeError):
    """Admission queue full: the request was shed, not enqueued."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before it could be dispatched."""


class DrainingError(RuntimeError):
    """The router is draining (or swapping): no new requests are admitted.

    In-flight and queued requests are still flushed — only *new* admissions
    are refused, so callers can retry on another fleet or after the swap.
    """


class RetriesExhaustedError(RuntimeError):
    """A request failed on every retry its budget allowed.

    Raised into the request's own future only — neighbors that shared a
    failed dispatch group are re-dispatched and served normally.
    """


# --------------------------------------------------------------------------
# Serialized frozen artifacts
# --------------------------------------------------------------------------
def save_deployed(deployed, artifact_dir) -> pathlib.Path:
    """Persist a ``DeployedDONN`` as a cold-startable serving artifact.

    Layout::

        artifact_dir/
          ARTIFACT.json   # format version, family, dsl.to_spec(cfg)
          planes/         # checkpoint.store tree: modulation planes + source

    The planes ride the store's atomic commit and crc32; ``ARTIFACT.json``
    is committed last via tmp+rename, so a directory with a manifest is a
    complete artifact.
    """
    from repro_torch.checkpoint import store
    from repro_torch.core import dsl

    artifact_dir = pathlib.Path(artifact_dir)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    frozen = deployed.frozen
    meta = {
        "format": ARTIFACT_FORMAT,
        "family": deployed.family,
        # None for uniform plans (one plane tuple); segment count for
        # segmented plans (tuple of tuples) — fixes the restore structure
        "segments": len(frozen) if deployed.heterogeneous else None,
        "plane_dtype": deployed.plane_dtype,
        "rfft_first": deployed.rfft_first,
        "spec": dsl.to_spec(deployed.cfg),
    }
    store.save(artifact_dir / PLANES_DIR, 0,
               {"frozen": frozen, "source": deployed.source}, keep=1)
    tmp = artifact_dir / (ARTIFACT_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, artifact_dir / ARTIFACT_FILE)
    return artifact_dir


def _read_meta(artifact_dir: pathlib.Path) -> dict:
    meta_path = artifact_dir / ARTIFACT_FILE
    if not meta_path.exists():
        raise FileNotFoundError(
            f"no {ARTIFACT_FILE} under {artifact_dir} — not a serving "
            "artifact (or an interrupted save: the manifest commits last)"
        )
    try:
        meta = json.loads(meta_path.read_text())
    except ValueError as e:
        raise ValueError(f"unparseable {ARTIFACT_FILE}: {e}") from e
    if meta.get("format") not in KNOWN_FORMATS:
        raise ValueError(
            f"unsupported artifact format {meta.get('format')!r} "
            f"(this build reads formats {KNOWN_FORMATS})"
        )
    return meta


def load_deployed(artifact_dir, *, verify: bool = True, device=None):
    """Cold-start a ``DeployedDONN`` on ``device`` (the CUDA card by
    default) from a serialized artifact, the port's or the JAX package's.

    Rebuilds the architecture from the JSON spec (``dsl.from_spec``, the
    validated path config-file builds use) and restores the frozen planes
    and the source field from the store (crc32 verified by default; a
    mismatch raises ``IOError``).  No parameters, optimizer state or
    codesign resolution are touched.
    """
    from repro_torch.checkpoint import store
    from repro_torch.core import dsl
    from repro_torch.runtime import inference as inf

    dev = resolve_device(device)
    artifact_dir = pathlib.Path(artifact_dir)
    meta = _read_meta(artifact_dir)
    model, _cfg = dsl.from_spec(meta["spec"], device=dev)
    nseg = meta.get("segments")
    # the target fixes the structure only (dtypes and shapes come from the
    # store's manifest): 2 leaves a plane tuple for f32/bf16 storage, 4 for
    # int8; format-1 artifacts are always f32 pairs
    plane_dtype = meta.get("plane_dtype", "float32")
    tup = (0.0, 0.0, 0.0, 0.0) if plane_dtype == "int8" else (0.0, 0.0)
    target = {
        "frozen": tup if nseg is None else tuple(tup for _ in range(nseg)),
        "source": 0.0,
    }
    state = store.restore(artifact_dir / PLANES_DIR, 0, target,
                          device=dev, verify=verify)
    return inf.deployed_from_model(model, state["frozen"],
                                   source=state["source"],
                                   rfft_first=bool(meta.get("rfft_first",
                                                            False)))


def validate_artifact(artifact_dir) -> dict:
    """Pre-deployment artifact check: metadata and architecture, no planes.

    The manifest exists and parses, the format is one this build reads,
    the family and plane dtype are known, the spec assembles
    (``dsl.spec_to_config``) and passes ``physics.validate_config``, and
    the plane store has a restorable step.  Raises ``FileNotFoundError`` /
    ``ValueError`` (including ``PhysicsValidationError``) naming the
    problem; returns the parsed metadata.  Nothing touches a device: the
    crc32 check stays a load-time one.
    """
    from repro_torch.checkpoint import store
    from repro_torch.core import dsl, physics

    artifact_dir = pathlib.Path(artifact_dir)
    meta = _read_meta(artifact_dir)
    if meta.get("family") not in ("cls", "multi", "seg"):
        raise ValueError(f"unknown model family {meta.get('family')!r}")
    if meta.get("plane_dtype", "float32") not in ("float32", "bfloat16",
                                                  "int8"):
        raise ValueError(f"unknown plane_dtype {meta.get('plane_dtype')!r}")
    spec = meta.get("spec")
    if not isinstance(spec, dict):
        raise ValueError(f"artifact spec missing/malformed under "
                         f"{artifact_dir}")
    try:
        cfg = dsl.spec_to_config(spec)
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"architecture spec does not assemble: {e!r}") from e
    errors = [v for v in physics.validate_config(cfg)
              if v.severity == physics.ERROR]
    if errors:
        raise physics.PhysicsValidationError(errors)
    if store.latest_step(artifact_dir / PLANES_DIR) is None:
        raise ValueError(
            f"no restorable plane store under {artifact_dir / PLANES_DIR} "
            "(missing or damaged checkpoint manifests)"
        )
    return meta


# --------------------------------------------------------------------------
# Engine supervision
# --------------------------------------------------------------------------
class EngineSupervisor:
    """Owns a serving engine on ``device``; health-checks, restarts,
    reports.

    Built around a serialized artifact rather than a live model: a failed
    engine is recovered by reloading the artifact from disk
    (``load_deployed`` + a fresh ``InferenceEngine`` + warmup), the path a
    cold-started replacement process would take.  The failed engine is
    dropped before its replacement loads, so a restart does not hold two
    deployments on the card.

    - ``infer(x)`` proxies to the engine; on failure it records the error,
      restarts from the artifact (bounded by ``max_restarts``) and retries
      the request once on the fresh engine.
    - ``health_check()`` pushes a probe batch through the engine and
      updates readiness without touching request stats.
    - ``stats()`` exposes ``ready``, ``restarts``, ``requests``,
      ``errors``, ``error_rate`` and the per-attempt ``restart_history``.

    Attempt k sleeps ``min(backoff_base_ms * 2**(k-1), backoff_max_ms)``
    scaled by a uniform ``[1, 1+backoff_jitter]`` factor first;
    ``backoff_base_ms=0`` restarts at once.  ``engine_factory(deployed) ->
    engine`` customizes engine construction (fault injection in tests).
    """

    def __init__(self, artifact_dir, *, buckets: Optional[Sequence[int]] = None,
                 engine_factory=None, max_restarts: int = 3,
                 warmup_buckets: Optional[Sequence[int]] = None,
                 verify: bool = True, backoff_base_ms: float = 50.0,
                 backoff_max_ms: float = 2000.0,
                 backoff_jitter: float = 0.25, seed: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.artifact_dir = pathlib.Path(artifact_dir)
        self.buckets = buckets
        self.engine_factory = engine_factory
        self.max_restarts = int(max_restarts)
        self.warmup_buckets = warmup_buckets
        self.verify = verify
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self.backoff_jitter = float(backoff_jitter)
        self._rng = random.Random(seed)
        self.engine = None
        self._ready = False
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "errors": 0, "restarts": 0,
                       "last_start_s": None, "restart_history": []}

    # --- lifecycle ---
    def _build_engine(self):
        from repro_torch.runtime.inference import (
            DEFAULT_BUCKETS, InferenceEngine,
        )

        deployed = load_deployed(self.artifact_dir, verify=self.verify,
                                 device=self.device)
        if self.engine_factory is not None:
            engine = self.engine_factory(deployed)
        else:
            engine = InferenceEngine(deployed,
                                     buckets=self.buckets or DEFAULT_BUCKETS,
                                     device=self.device)
        if hasattr(engine, "warmup"):
            engine.warmup(self.warmup_buckets)
        return engine

    def start(self):
        """Cold-start the engine from the artifact (idempotent)."""
        with self._lock:
            if self.engine is None:
                t0 = time.perf_counter()
                self.engine = self._build_engine()
                self._stats["last_start_s"] = time.perf_counter() - t0
                self._ready = True
        return self

    def restart_backoff_s(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (1-indexed): exp + jitter."""
        if self.backoff_base_ms <= 0:
            return 0.0
        base = min(self.backoff_base_ms * 2.0 ** (attempt - 1),
                   self.backoff_max_ms)
        return base * (1.0 + self.backoff_jitter * self._rng.random()) / 1e3

    def restart(self):
        """Drop the engine and rebuild it from the artifact.

        Each attempt sleeps its backoff first and is recorded in
        ``stats()["restart_history"]``.
        """
        with self._lock:
            if self._stats["restarts"] >= self.max_restarts:
                self._ready = False
                raise RuntimeError(
                    f"engine restart budget exhausted "
                    f"({self.max_restarts} restarts)"
                )
            self._stats["restarts"] += 1
            attempt = self._stats["restarts"]
            self._ready = False
            self.engine = None  # free its deployment before the reload
            backoff_s = self.restart_backoff_s(attempt)
            if backoff_s > 0:
                time.sleep(backoff_s)
            t0 = time.perf_counter()
            self.engine = self._build_engine()
            self._stats["last_start_s"] = time.perf_counter() - t0
            self._stats["restart_history"].append(
                {"attempt": attempt, "backoff_s": round(backoff_s, 4),
                 "rebuild_s": round(self._stats["last_start_s"], 4)}
            )
            self._ready = True
        return self

    # --- serving ---
    def infer(self, x) -> np.ndarray:
        """Serve through the engine; restart from the artifact on failure.

        The failed request is retried once on the restarted engine; a
        second failure (or an exhausted restart budget) propagates to the
        caller with the supervisor marked not-ready.
        """
        if self.engine is None:
            self.start()
        self._stats["requests"] += 1
        try:
            return self.engine.infer(x)
        except Exception:  # noqa: BLE001 - any engine fault restarts it
            self._stats["errors"] += 1
            self._ready = False
        # outside the handler: its traceback would keep the failed engine
        # (and its deployment) alive through the restart
        self.restart()  # raises when the budget is exhausted
        try:
            return self.engine.infer(x)
        except Exception:
            self._stats["errors"] += 1
            self._ready = False
            raise

    def health_check(self) -> bool:
        """Probe the engine with a zero batch; update + return readiness."""
        if self.engine is None:
            return False
        try:
            probe = self.engine._example(self.engine.buckets[0])
            self.engine.infer(probe)
            self._ready = True
        except Exception:  # noqa: BLE001 - the probe is the check
            self._ready = False
        return self._ready

    # --- introspection ---
    @property
    def ready(self) -> bool:
        return self._ready and self.engine is not None

    def stats(self) -> dict:
        s = dict(self._stats)
        s["restart_history"] = list(s["restart_history"])
        s["ready"] = self.ready
        s["error_rate"] = s["errors"] / max(s["requests"], 1)
        return s
