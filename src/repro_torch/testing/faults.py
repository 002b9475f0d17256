"""Fault injectors: software failures and device physics faults.

The port of ``repro.testing.faults``; one harness drives the resilience
tests (``tests/test_torch_persistence.py``, ``tests/test_torch_fleet.py``)
and ``chip_smoke.py``'s persistence phase.

**Software faults**
- ``FlakyEngine`` — engine proxy that raises on chosen calls or after
  ``kill()`` (crashed-replica scenario for ``EngineSupervisor``);
- ``SlowEngine`` — engine proxy that stalls each call (deadline expiry);
- ``CrashingEngine`` — engine proxy that dies permanently after K
  requests, optionally only once armed; ``kill_replica`` kills the first
  live crashable replica of a running fleet;
- ``corrupt_chunk`` / ``flip_crc`` — bit-rot a checkpoint chunk file /
  falsify its manifest checksum;
- ``poison_batches`` — inject NaN batches into a training stream.

**Physics faults** (frozen-plane non-idealities of real SLM / printed
hardware)
- ``perturb_frozen`` — Gaussian phase noise, dead (phase-stuck) pixels
  and integer-pixel lateral misalignment applied to a ``DeployedDONN``'s
  frozen planes, returning a new deployment.  It draws from
  ``np.random.default_rng(seed)`` and computes in float64 numpy, as the
  reference does, so the same planes and seed give the reference's
  perturbed planes bit for bit; the result goes back to the deployment's
  device.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


# --------------------------------------------------------------------------
# Software faults: flaky / slow engines
# --------------------------------------------------------------------------
class FlakyEngine:
    """Engine proxy raising on selected calls (1-indexed) or after kill().

    Wraps anything with an ``infer`` method; every other attribute
    (``deployed``, ``buckets``, ``stats``, ``warmup``...) delegates to the
    wrapped engine, so it drops into ``MicroBatcher`` and
    ``EngineSupervisor`` unchanged.
    """

    def __init__(self, engine, fail_calls: Iterable[int] = (),
                 exc_type=RuntimeError):
        self._engine = engine
        self.fail_calls = set(int(c) for c in fail_calls)
        self.exc_type = exc_type
        self.calls = 0
        self.dead = False

    def kill(self):
        """Fail every call from now on (a crashed / wedged replica)."""
        self.dead = True

    def infer(self, x):
        self.calls += 1
        if self.dead:
            raise self.exc_type("engine is dead")
        if self.calls in self.fail_calls:
            raise self.exc_type(f"injected failure on call {self.calls}")
        return self._engine.infer(x)

    def __getattr__(self, name):
        return getattr(self._engine, name)


class CrashingEngine:
    """Engine proxy that dies permanently after ``crash_after`` requests.

    Unlike ``FlakyEngine`` (which fails selected calls and then recovers),
    a crashed replica stays down until something external rebuilds it —
    the mid-run replica-crash scenario for ``FleetRouter``: every request
    in flight on this replica must be retried on a healthy one, with zero
    drops.  With ``crash_on_drain=True`` the countdown only starts once
    ``arm()`` is called (a drill arms it as the drain begins, so
    the crash lands during the flush).  ``kill()`` crashes it immediately.
    """

    def __init__(self, engine, crash_after: int = 1,
                 crash_on_drain: bool = False, exc_type=RuntimeError):
        self._engine = engine
        self.crash_after = int(crash_after)
        self.crash_on_drain = bool(crash_on_drain)
        self.exc_type = exc_type
        self.calls = 0
        self.armed = not crash_on_drain
        self.dead = False

    def arm(self):
        """Start the crash countdown (drain has begun)."""
        self.armed = True
        self.calls = 0

    def kill(self):
        """Crash immediately and stay down."""
        self.dead = True

    def infer(self, x):
        if self.dead:
            raise self.exc_type("replica crashed (stays down)")
        if self.armed:
            self.calls += 1
            if self.calls > self.crash_after:
                self.dead = True
                raise self.exc_type(
                    f"replica crashed after {self.crash_after} request(s)"
                )
        return self._engine.infer(x)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def kill_replica(router, index: Optional[int] = None):
    """Kill one replica of a live fleet; returns the killed engine proxy.

    Picks replica ``index`` (default: the first whose engine exposes
    ``kill()`` and is not already dead) and crashes it in place — the
    mid-run fleet failover scenario.  Raises ``ValueError`` when no
    replica is killable.
    """
    reps = router.replicas
    if index is not None:
        candidates = [reps[index]]
    else:
        candidates = [r for r in reps
                      if hasattr(r.engine, "kill")
                      and not getattr(r.engine, "dead", False)]
    for rep in candidates:
        if hasattr(rep.engine, "kill"):
            rep.engine.kill()
            return rep.engine
    raise ValueError("no killable replica (wrap engines in FlakyEngine / "
                     "CrashingEngine to enable kill_replica)")


class SlowEngine:
    """Engine proxy adding ``delay_s`` of stall to every call."""

    def __init__(self, engine, delay_s: float):
        self._engine = engine
        self.delay_s = float(delay_s)

    def infer(self, x):
        time.sleep(self.delay_s)
        return self._engine.infer(x)

    def __getattr__(self, name):
        return getattr(self._engine, name)


# --------------------------------------------------------------------------
# Software faults: checkpoint corruption
# --------------------------------------------------------------------------
def _chunk_path(ckpt_dir, step: int, leaf: int, chunk: int) -> pathlib.Path:
    return (pathlib.Path(ckpt_dir) / f"step_{step:08d}"
            / f"leaf_{leaf:05d}.c{chunk:03d}.npy")


def corrupt_chunk(ckpt_dir, step: int, leaf: int = 0, chunk: int = 0):
    """Flip the last payload byte of a checkpoint chunk file (bit-rot).

    The manifest's crc32 is left intact, so a verifying restore must
    reject the chunk; a non-verifying restore would silently load garbage.
    """
    path = _chunk_path(ckpt_dir, step, leaf, chunk)
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    return path


def flip_crc(ckpt_dir, step: int, leaf: int = 0, chunk: int = 0):
    """Falsify a chunk's manifest crc32 (metadata corruption).

    The chunk data stays valid but no longer matches its recorded
    checksum — a verifying restore must refuse it.
    """
    mpath = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    entry = manifest["leaves"][leaf]["chunks"][chunk]
    entry["crc32"] = (entry["crc32"] or 0) ^ 1
    mpath.write_text(json.dumps(manifest))
    return mpath


# --------------------------------------------------------------------------
# Software faults: poisoned training data
# --------------------------------------------------------------------------
def poison_batches(it: Iterator, poison_steps: Iterable[int],
                   value: float = np.nan) -> Iterator:
    """Replace the inputs of selected batches (0-indexed) with ``value``.

    Yields ``(xb, yb)`` pairs unchanged except at ``poison_steps``, where
    ``xb`` becomes a full-``value`` array — the NaN-batch scenario the
    guarded train chunk must skip.
    """
    poison = set(int(s) for s in poison_steps)
    for i, (xb, yb) in enumerate(it):
        if i in poison:
            xb = np.full_like(np.asarray(xb), value)
        yield xb, yb


# --------------------------------------------------------------------------
# Physics faults: frozen modulation-plane non-idealities
# --------------------------------------------------------------------------
def _perturb_pair(pair, rng, use_pallas: bool, phase_sigma: float,
                  dead_frac: float, shift_px: int):
    """The reference's ``_perturb_pair`` on a pair of plane tensors: the
    same draws and the same float64 numpy arithmetic, so equal planes and
    seeds give equal results bit for bit."""
    if len(pair) != 2:
        raise ValueError("perturb_frozen takes float32 or bfloat16 plane "
                         "pairs, not int8 4-tuples")
    bf16 = pair[0].dtype == torch.bfloat16
    a, b = (p.float().cpu().numpy() for p in pair)
    if phase_sigma or dead_frac:
        # recover (phase, amplitude): the use_pallas convention stores them
        # directly; the plain one stores cartesian gamma*exp(j theta)
        if use_pallas:
            theta, amp = a.astype(np.float64), b.astype(np.float64)
        else:
            theta = np.arctan2(b.astype(np.float64), a.astype(np.float64))
            amp = np.hypot(a, b)
            if bf16:  # numpy's bf16 hypot: f32, then rounded to bf16
                amp = torch.from_numpy(amp).to(torch.bfloat16).float()
                amp = amp.numpy()
            amp = amp.astype(np.float64)
        if phase_sigma:
            theta = theta + rng.normal(0.0, phase_sigma, theta.shape)
        if dead_frac:
            # dead SLM pixels: stuck at phase 0, amplitude response intact
            theta = np.where(rng.random(theta.shape) < dead_frac, 0.0, theta)
        if use_pallas:
            a, b = theta, amp
        else:
            a, b = amp * np.cos(theta), amp * np.sin(theta)
    if shift_px:
        # lateral misalignment: roll both planes along the last axis —
        # identical in either split convention
        a = np.roll(a, shift_px, axis=-1)
        b = np.roll(b, shift_px, axis=-1)
    return (np.asarray(a, np.float32), np.asarray(b, np.float32))


def perturb_frozen(deployed, *, phase_sigma: float = 0.0,
                   dead_frac: float = 0.0, shift_px: int = 0,
                   seed: Optional[int] = 0):
    """Device non-idealities applied to a frozen artifact's planes.

    - ``phase_sigma``: i.i.d. Gaussian phase noise (radians) per plane
      element — SLM phase-response jitter / calibration error;
    - ``dead_frac``: fraction of plane elements stuck at phase 0 (dead
      SLM pixels, amplitude response preserved);
    - ``shift_px``: whole-plane lateral misalignment, in pixels.

    Returns a **new** ``DeployedDONN`` on the original's device, sharing
    its plan and detector (the original's planes are untouched); with all
    faults zero the planes are the original's tensors, so robustness
    sweeps have an exact baseline.  Perturbed planes are float32 pairs
    whatever the storage dtype, as in the reference.  The deployment keeps
    its ``rfft_first`` first hop (the reference's drops it).
    """
    from repro_torch.runtime.inference import DeployedDONN

    rng = np.random.default_rng(seed)
    use_pallas = bool(deployed.cfg.use_pallas)
    dev = deployed.device

    def one(pair):
        if not (phase_sigma or dead_frac or shift_px):
            return pair
        a, b = _perturb_pair(pair, rng, use_pallas, phase_sigma,
                             dead_frac, shift_px)
        return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))

    if deployed.heterogeneous:
        frozen = tuple(one(p) for p in deployed.frozen)
    else:
        frozen = one(deployed.frozen)
    return DeployedDONN(
        deployed.cfg, deployed.family, deployed.plan, frozen,
        deployed.source, deployed.in_n, detector=deployed.detector,
        skip_from=deployed.skip_from, skip_hop=deployed.skip_hop,
        out_grid=deployed.out_grid, rfft_first=deployed.rfft_first,
        device=dev,
    )
