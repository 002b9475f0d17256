"""Continuous batching and a fault-tolerant multi-replica serving fleet.

The port of ``repro.runtime.fleet``, host code around the serving engines:

1.  **Continuous batching** — an admission loop instead of a deadline.
    When any replica is idle and work is queued, the dispatcher launches
    at once with whatever is queued (padded to the nearest bucket by the
    engine); when every replica is busy, arrivals coalesce into the open
    slot and ride the next free replica as one batch.
2.  **Fleet dispatch** — ``FleetRouter`` manages N replicas (built from a
    serialized artifact through ``EngineSupervisor``, or any engine-likes)
    with least-loaded placement, tie-broken by error rate.  A replica that
    fails a group is circuit-broken with exponential-backoff probation
    (plus jitter) and probed with a solo group before it regains traffic.
3.  **Bounded retries, zero drops** — a failed group splits in half and
    re-dispatches (a poison request isolates in log2(B) splits and fails
    only its own future with ``RetriesExhaustedError``); solo failures
    requeue with exponential backoff + jitter, up to ``max_retries``.
4.  **Graceful drain and warm swap** — ``drain()`` stops admission
    (``DrainingError``) and flushes every queued and in-flight request;
    ``swap_artifact(dir)`` validates the new artifact first, then rolls the
    fleet one replica at a time while the rest keeps serving.

On the card, replicas share one device and its default stream (a stream
an engine bought no throughput: the workers are Python threads under one
interpreter lock, and that lock sets the rate; ``scripts/fleet_threads.py``
measures both).  Every replica warms all its buckets before it takes
traffic, so the plan's lazily built device constants are filled once and
never by two threads at a time.  A
re-dispatched request is served bit-identically when the fleet serves one
bucket: the detector readout (K3) has no atomics and its result does not
depend on the batch.
"""
from __future__ import annotations

import pathlib
import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.runtime.resilience import (
    DeadlineExceededError, DrainingError, OverloadedError,
    RetriesExhaustedError, validate_artifact,
)


def _deployed_of(engine):
    """The ``DeployedDONN`` behind an engine-like (supervisor/proxy-aware)."""
    for hop in range(4):
        dep = getattr(engine, "deployed", None)
        if dep is not None:
            return dep
        engine = getattr(engine, "engine", None)
        if engine is None:
            return None
    return None


def _buckets_of(engine) -> tuple:
    """The serving buckets behind an engine-like (supervisor/proxy-aware)."""
    from repro_torch.runtime.inference import DEFAULT_BUCKETS

    for hop in range(4):
        if engine is None:
            break
        b = getattr(engine, "buckets", None)
        if b:
            return tuple(sorted(int(x) for x in b))
        engine = getattr(engine, "engine", None)
    return tuple(DEFAULT_BUCKETS)


class _FleetRequest:
    """One queued request (slots: the admission loop is the hot path)."""

    __slots__ = ("x", "future", "t_arrival", "deadline", "attempts",
                 "not_before")

    def __init__(self, x, future, t_arrival, deadline):
        self.x = x
        self.future = future
        self.t_arrival = t_arrival
        self.deadline = deadline  # absolute perf_counter time, or None
        self.attempts = 0  # failed dispatches so far
        self.not_before = 0.0  # retry backoff: ineligible until then


class _Replica:
    """One engine replica + its placement/health state (router-locked)."""

    def __init__(self, name: str, engine, build: Optional[Callable] = None):
        self.name = name
        self.engine = engine
        self.build = build  # build(artifact_dir) -> fresh warmed engine
        self.inflight = 0  # requests currently placed on this replica
        self.accepting = True  # False while draining for a swap
        self.healthy = True
        self.fail_streak = 0
        self.probation_until = 0.0
        self.served = 0
        self.errors = 0
        self.work: List = []  # dispatched groups awaiting this worker
        self.cv: Optional[threading.Condition] = None  # router's cv

    @property
    def engine_ready(self) -> bool:
        return bool(getattr(self.engine, "ready", True))

    def eligible(self, now: float) -> bool:
        """Can dispatch place new work here right now?"""
        if not self.accepting or self.work or self.inflight:
            return False
        if self.healthy and self.engine_ready:
            return True
        # circuit-broken: eligible again once probation expires (the
        # dispatcher sends a solo probe group first)
        return now >= self.probation_until

    def stats(self) -> dict:
        out = {"served": self.served, "errors": self.errors,
               "inflight": self.inflight, "healthy": self.healthy,
               "accepting": self.accepting,
               "fail_streak": self.fail_streak}
        sub = getattr(self.engine, "stats", None)
        if callable(sub):
            try:
                out["engine"] = sub()
            except Exception:  # noqa: BLE001 - stats must never raise
                pass
        return out


class FleetRouter:
    """Continuous-batching admission loop over N serving replicas.

    ``replicas`` is a sequence of engine-likes (anything with
    ``infer(batch)``: ``InferenceEngine``, ``EngineSupervisor``, the
    fault-injection proxies in ``repro_torch.testing.faults``) or
    ``(engine, build)`` pairs where ``build(artifact_dir)`` constructs a
    fresh warmed replacement engine (required for ``swap_artifact``).
    ``FleetRouter.from_artifact`` builds a supervised fleet from a
    serialized artifact directory.

    ``submit(x, timeout_ms=...)`` returns a ``Future``; typed failures:

    - ``OverloadedError`` — admission queue full (bounded by
      ``max_queue``), request shed at the door;
    - ``DrainingError`` — fleet is draining/swapping, not admitting;
    - ``DeadlineExceededError`` — ``timeout_ms`` expired while the
      request was still queued in an open slot;
    - ``RetriesExhaustedError`` — the request failed ``max_retries + 1``
      solo dispatches (its group-mates are unaffected).
    """

    def __init__(self, replicas: Sequence, *, max_queue: Optional[int] = 1024,
                 max_retries: int = 3, backoff_base_ms: float = 5.0,
                 backoff_max_ms: float = 500.0, backoff_jitter: float = 0.5,
                 probation_base_ms: float = 20.0,
                 probation_max_ms: float = 2000.0, validate: bool = True,
                 seed: Optional[int] = 0):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.max_queue = None if not max_queue else int(max_queue)
        self.max_retries = int(max_retries)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self.backoff_jitter = float(backoff_jitter)
        self.probation_base_ms = float(probation_base_ms)
        self.probation_max_ms = float(probation_max_ms)
        self.validate = validate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._replicas: List[_Replica] = []
        for i, item in enumerate(replicas):
            engine, build = item if isinstance(item, tuple) else (item, None)
            rep = _Replica(f"r{i}", engine, build)
            rep.cv = self._cv
            self._replicas.append(rep)
        self._deployed = next(
            (d for d in map(_deployed_of, (r.engine for r in self._replicas))
             if d is not None), None)
        self.bucket_max = max(
            max(_buckets_of(r.engine)) for r in self._replicas
        )
        # pending units: (pinned, [requests]); non-pinned units are always
        # single requests and coalesce at dispatch; pinned units are retry
        # groups that dispatch exactly as-is (poison isolation)
        self._pending: List = []
        self._queued = 0
        self._draining = False
        self._closed = False
        self.stats_counters = {
            "submitted": 0, "served": 0, "shed": 0, "expired": 0,
            "failed": 0, "retried": 0, "splits": 0, "rejected_draining": 0,
            "replica_failures": 0, "dispatches": 0, "swaps": 0,
        }
        self._workers = [
            threading.Thread(target=self._worker, args=(rep,), daemon=True)
            for rep in self._replicas
        ]
        for t in self._workers:
            t.start()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def from_artifact(cls, artifact_dir, *, replicas: int = 2,
                      buckets: Optional[Sequence[int]] = None,
                      engine_factory=None, max_restarts: int = 3,
                      supervisor_backoff_base_ms: float = 50.0,
                      verify: bool = True,
                      warmup_buckets: Optional[Sequence[int]] = None,
                      device=None, **router_kw) -> "FleetRouter":
        """A fleet of N ``EngineSupervisor``-wrapped replicas from disk, on
        ``device`` (the CUDA card by default; every replica on it).

        The artifact is validated (format version + architecture spec)
        before any replica warms up; each replica supervises its own
        engine (restart-from-artifact with backoff) and is warmed
        (``warmup_buckets``, every bucket by default) before the next is
        built, and each carries a ``build`` factory so ``swap_artifact``
        can roll it onto a new artifact warm.
        """
        from repro_torch.runtime.resilience import EngineSupervisor

        dev = resolve_device(device)
        validate_artifact(artifact_dir)
        artifact_dir = pathlib.Path(artifact_dir)

        def build(target_dir, _seed):
            return EngineSupervisor(
                target_dir, buckets=buckets, engine_factory=engine_factory,
                max_restarts=max_restarts,
                backoff_base_ms=supervisor_backoff_base_ms,
                warmup_buckets=warmup_buckets, verify=verify, seed=_seed,
                device=dev,
            ).start()

        pairs = []
        for i in range(int(replicas)):
            mk = (lambda s: lambda d: build(d, s))(i)
            pairs.append((build(artifact_dir, i), mk))
        router = cls(pairs, **router_kw)
        router.artifact_dir = artifact_dir
        return router

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, x, timeout_ms: Optional[float] = None) -> Future:
        """Admit one request into the open slot; returns its ``Future``."""
        from repro_torch.runtime.inference import validate_request

        x = np.asarray(x)
        if self.validate and self._deployed is not None:
            validate_request(self._deployed, x)
        now = time.perf_counter()
        deadline = None if timeout_ms is None else now + timeout_ms / 1e3
        fut: Future = Future()
        req = _FleetRequest(x, fut, now, deadline)
        with self._cv:
            if self._closed:
                raise RuntimeError("FleetRouter is closed")
            if self._draining:
                self.stats_counters["rejected_draining"] += 1
                raise DrainingError(
                    "fleet is draining: new requests are not admitted "
                    "(queued and in-flight requests are still served)"
                )
            if self.max_queue is not None and self._queued >= self.max_queue:
                self.stats_counters["shed"] += 1
                raise OverloadedError(
                    f"admission queue full ({self.max_queue} pending)"
                )
            self._pending.append((False, [req]))
            self._queued += 1
            self.stats_counters["submitted"] += 1
            self._cv.notify_all()
        return fut

    # ------------------------------------------------------------------
    # dispatch: the continuous-batching admission loop
    # ------------------------------------------------------------------
    def _request_backoff_s(self, attempts: int) -> float:
        base = min(self.backoff_base_ms * 2.0 ** max(attempts - 1, 0),
                   self.backoff_max_ms)
        return base * (1.0 + self.backoff_jitter * self._rng.random()) / 1e3

    def _probation_s(self, fail_streak: int) -> float:
        base = min(self.probation_base_ms * 2.0 ** max(fail_streak - 1, 0),
                   self.probation_max_ms)
        return base * (1.0 + self.backoff_jitter * self._rng.random()) / 1e3

    def _expire_locked(self, now: float) -> List[_FleetRequest]:
        """Pop deadline-expired requests out of the pending units."""
        expired: List[_FleetRequest] = []
        kept: List = []
        for pinned, reqs in self._pending:
            live = []
            for r in reqs:
                if r.deadline is not None and now >= r.deadline:
                    expired.append(r)
                else:
                    live.append(r)
            if live:
                kept.append((pinned, live))
        if expired:
            self._pending = kept
            self._queued -= len(expired)
            self.stats_counters["expired"] += len(expired)
        return expired

    def _pick_replica(self, now: float) -> Optional[_Replica]:
        """Least-loaded placement over ready replicas; error-rate tiebreak."""
        best, best_key = None, None
        for rep in self._replicas:
            if not rep.eligible(now):
                continue
            err_rate = rep.errors / max(rep.served + rep.errors, 1)
            key = (rep.inflight, not rep.healthy, err_rate)
            if best_key is None or key < best_key:
                best, best_key = rep, key
        return best

    def _form_group_locked(self, rep: _Replica,
                           now: float) -> Optional[List[_FleetRequest]]:
        """Take the next dispatchable group off the pending queue.

        The first eligible unit decides: a pinned retry unit dispatches
        exactly as-is; otherwise eligible singles coalesce up to the
        bucket limit (a circuit-broken replica on probation gets a solo
        probe instead of a full group).
        """
        limit = 1 if not rep.healthy else self.bucket_max
        group: List[_FleetRequest] = []
        taken: List[int] = []
        pinned_take = None
        for i, (pinned, reqs) in enumerate(self._pending):
            if any(r.not_before > now for r in reqs):
                continue
            if pinned:
                if not group:
                    pinned_take = i
                break
            for r in reqs:
                group.append(r)
                taken.append(i)
                if len(group) >= limit:
                    break
            if len(group) >= limit:
                break
        if pinned_take is not None:
            _, group = self._pending.pop(pinned_take)
        elif group:
            for i in reversed(taken):
                self._pending.pop(i)
        else:
            return None
        self._queued -= len(group)
        return group

    def _next_timer_locked(self, now: float) -> Optional[float]:
        """Seconds until the next retry/deadline/probation timer fires."""
        ts = []
        for _, reqs in self._pending:
            for r in reqs:
                if r.not_before > now:
                    ts.append(r.not_before)
                if r.deadline is not None:
                    ts.append(r.deadline)
        if self._pending:
            for rep in self._replicas:
                if (rep.accepting and not rep.work and not rep.inflight
                        and not rep.healthy and rep.probation_until > now):
                    ts.append(rep.probation_until)
        return max(min(ts) - now, 0.0) if ts else None

    def _dispatch_loop(self):
        while True:
            resolve: List = []
            with self._cv:
                while True:
                    now = time.perf_counter()
                    expired = self._expire_locked(now)
                    if expired:
                        resolve = expired
                        break
                    if self._closed and not self._pending:
                        return
                    rep = self._pick_replica(now) if self._pending else None
                    group = (self._form_group_locked(rep, now)
                             if rep is not None else None)
                    if group is not None:
                        rep.inflight += len(group)
                        rep.work.append(group)
                        self.stats_counters["dispatches"] += 1
                        self._cv.notify_all()
                        continue  # more pending work may dispatch now
                    self._cv.wait(timeout=self._next_timer_locked(now) or 0.1)
            for r in resolve:
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        "request deadline expired while queued in an open "
                        "slot"
                    ))

    # ------------------------------------------------------------------
    # replica workers
    # ------------------------------------------------------------------
    def _worker(self, rep: _Replica):
        while True:
            with self._cv:
                while not rep.work and not self._closed:
                    self._cv.wait(timeout=0.1)
                if rep.work:
                    group = rep.work.pop(0)
                elif self._closed:
                    return
                else:
                    continue
            try:
                xs = np.stack([r.x for r in group])
                outs = rep.engine.infer(xs)
            except Exception as e:  # noqa: BLE001 - any replica fault
                self._backoff_and_requeue(rep, group, e)
                continue
            with self._cv:
                rep.inflight -= len(group)
                rep.served += len(group)
                rep.fail_streak = 0
                rep.healthy = True
                self.stats_counters["served"] += len(group)
                self._cv.notify_all()
            for r, out in zip(group, outs):
                if not r.future.done():
                    r.future.set_result(out)

    def _backoff_and_requeue(self, rep: _Replica, group: List[_FleetRequest],
                             exc: Exception):
        """Failure path: circuit-break the replica, never drop a request.

        Groups split in half and requeue pinned (isolating a poison
        request in log2(B) splits); solo failures charge the request's
        retry budget and requeue with exponential backoff + jitter.
        """
        now = time.perf_counter()
        failed: List[_FleetRequest] = []
        with self._cv:
            rep.inflight -= len(group)
            rep.errors += 1
            rep.fail_streak += 1
            rep.healthy = False
            rep.probation_until = now + self._probation_s(rep.fail_streak)
            self.stats_counters["replica_failures"] += 1
            for r in group:
                r.attempts += 1
            if self._closed:
                # shutdown already swept the queue: fail rather than
                # strand a requeued future nobody will ever dispatch
                self.stats_counters["failed"] += len(group)
                failed = group
            elif len(group) == 1:
                r = group[0]
                if r.attempts > self.max_retries:
                    self.stats_counters["failed"] += 1
                    failed.append(r)
                else:
                    r.not_before = now + self._request_backoff_s(r.attempts)
                    self._pending.insert(0, (True, [r]))
                    self._queued += 1
                    self.stats_counters["retried"] += 1
            else:
                mid = len(group) // 2
                nb = now + self._request_backoff_s(
                    min(r.attempts for r in group))
                for half in (group[mid:], group[:mid]):
                    for r in half:
                        r.not_before = nb
                    self._pending.insert(0, (True, half))
                    self._queued += len(half)
                self.stats_counters["splits"] += 1
                self.stats_counters["retried"] += len(group)
            self._cv.notify_all()
        for r in failed:
            if not r.future.done():
                r.future.set_exception(RetriesExhaustedError(
                    f"request failed {r.attempts} dispatch attempts "
                    f"(budget max_retries={self.max_retries}); last "
                    f"replica error: {exc!r}"
                ))

    # ------------------------------------------------------------------
    # drain / swap / close
    # ------------------------------------------------------------------
    def _flushed_locked(self) -> bool:
        return (not self._pending
                and all(r.inflight == 0 and not r.work
                        for r in self._replicas))

    def drain(self, timeout: float = 60.0) -> bool:
        """Stop admitting; flush every queued + in-flight request.

        New ``submit`` calls raise ``DrainingError`` until ``resume()``.
        Returns True when the fleet is fully flushed within ``timeout``.
        """
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            return self._cv.wait_for(self._flushed_locked, timeout=timeout)

    def resume(self):
        """Reopen admission after a ``drain()``."""
        with self._cv:
            self._draining = False
            self._cv.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining

    def swap_artifact(self, artifact_dir, *, rolling: bool = True,
                      timeout: float = 120.0) -> dict:
        """Warm model swap from a (validated) serialized artifact.

        ``rolling=True`` (default) swaps one replica at a time: placement
        stops on it, its in-flight work flushes, a fresh engine is built
        + warmed from the new artifact *while the rest of the fleet keeps
        serving*, then it returns to rotation — admission never closes
        and no request is dropped.  ``rolling=False`` drains the whole
        fleet first (admission closed for the duration), swaps every
        replica, then resumes.  Either way the artifact's format version
        and architecture spec are validated before any replica is
        touched.  Returns the artifact metadata.
        """
        meta = validate_artifact(artifact_dir)
        no_build = [r.name for r in self._replicas if r.build is None]
        if no_build:
            raise RuntimeError(
                f"replicas {no_build} have no build factory; construct the "
                "router with (engine, build) pairs or from_artifact() to "
                "enable swaps"
            )
        if not rolling:
            if not self.drain(timeout=timeout):
                raise TimeoutError("fleet did not flush within the swap "
                                   "timeout; swap aborted before rebuild")
        for rep in self._replicas:
            with self._cv:
                rep.accepting = False
                ok = self._cv.wait_for(
                    lambda: rep.inflight == 0 and not rep.work,
                    timeout=timeout,
                )
            if not ok:
                with self._cv:
                    rep.accepting = True
                raise TimeoutError(
                    f"replica {rep.name} did not flush within the swap "
                    "timeout; it was returned to rotation on the old model"
                )
            engine = rep.build(artifact_dir)  # built + warmed outside the lock
            with self._cv:
                rep.engine = engine
                rep.healthy = True
                rep.fail_streak = 0
                rep.probation_until = 0.0
                rep.accepting = True
                self._cv.notify_all()
        self._deployed = next(
            (d for d in map(_deployed_of, (r.engine for r in self._replicas))
             if d is not None), None)
        self.artifact_dir = pathlib.Path(artifact_dir)
        if not rolling:
            self.resume()
        self.stats_counters["swaps"] += 1
        return meta

    def close(self, timeout: float = 30.0) -> bool:
        """Flush and stop the fleet.

        Returns True on a clean flush + join; on timeout every unresolved
        queued/in-flight future is failed with ``RuntimeError`` and False
        is returned.
        """
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        with self._cv:
            flushed = self._cv.wait_for(
                self._flushed_locked,
                timeout=max(deadline - time.monotonic(), 0.01),
            )
            self._closed = True
            self._cv.notify_all()
        self._dispatcher.join(timeout=max(deadline - time.monotonic(), 0.01))
        for t in self._workers:
            t.join(timeout=max(deadline - time.monotonic(), 0.01))
        clean = flushed and not self._dispatcher.is_alive() and not any(
            t.is_alive() for t in self._workers
        )
        if clean:
            return True
        with self._cv:
            stranded = [r for _, reqs in self._pending for r in reqs]
            self._pending = []
            self._queued = 0
        err = RuntimeError(
            f"FleetRouter shutdown unclean: {len(stranded)} queued "
            f"request(s) abandoned after {timeout}s"
        )
        for r in stranded:
            if not r.future.done():
                r.future.set_exception(err)
        return False

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def health_check(self) -> dict:
        """Probe every idle replica with a tiny zero batch; {name: ok}.

        A replica that passes is returned to rotation immediately
        (probation cleared); busy replicas are skipped (reported as their
        current health) rather than queued behind live traffic.
        """
        from repro_torch.runtime.inference import expected_request_shape

        out = {}
        for rep in self._replicas:
            with self._cv:
                if rep.inflight or rep.work:
                    out[rep.name] = rep.healthy
                    continue
                rep.inflight += 1  # hold the slot while probing
            try:
                if self._deployed is not None:
                    probe = np.zeros(
                        (1,) + expected_request_shape(self._deployed),
                        np.float32)
                    rep.engine.infer(probe)
                ok = True
            except Exception:  # noqa: BLE001 - the probe IS the check
                ok = False
            with self._cv:
                rep.inflight -= 1
                rep.healthy = ok
                if ok:
                    rep.fail_streak = 0
                    rep.probation_until = 0.0
                self._cv.notify_all()
            out[rep.name] = ok
        return out

    @property
    def replicas(self) -> tuple:
        return tuple(self._replicas)

    def stats(self) -> dict:
        with self._cv:
            s = dict(self.stats_counters)
            s["queued"] = self._queued
            s["draining"] = self._draining
            s["replicas"] = {r.name: r.stats() for r in self._replicas}
        return s


class ContinuousBatcher(FleetRouter):
    """Single-engine continuous batching: ``MicroBatcher`` without the
    launch deadline.

    The same admission loop as the fleet, over one replica: an idle
    engine dispatches the instant a request arrives (batch 1, minimum
    latency); under load, arrivals coalesce into the open slot and the
    next dispatch carries them as one bucket-padded batch.  Drop-in for
    ``MicroBatcher(engine)`` minus ``max_wait_ms`` — there is nothing to
    tune.
    """

    def __init__(self, engine, **kw):
        super().__init__([engine], **kw)
