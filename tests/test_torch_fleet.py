"""The port's continuous-batching fleet on the CPU: admission and failover.

Mirrors the reference's ``tests/test_fleet.py`` class for class at its
small sizes, on the port's ``runtime.fleet`` / ``runtime.resilience`` /
``testing.faults``:

- **continuous admission**: an idle fleet dispatches at once (batch 1);
  arrivals during an in-flight batch coalesce into the open slot;
  submit-during-drain raises ``DrainingError``; a deadline that expires in
  the open slot fails only that future;
- **failover, zero drops**: a mid-run replica kill re-serves its group on
  a healthy replica bit-identically; N-1 dead replicas still serve
  everything; a poison request isolates by group splits and exhausts only
  its own retry budget;
- **drain and warm swap** from artifacts, validated first;
- **supervisor backoff** and the crash injectors.

Engines over real deployments get ``device="cpu"`` (they default to the
card); the fleet itself is host code and takes no device.
"""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import numpy as np  # noqa: E402

from repro_torch.core.config import DONNConfig  # noqa: E402
from repro_torch.core.models import build_model  # noqa: E402
from repro_torch.runtime.fleet import ContinuousBatcher, FleetRouter  # noqa: E402,E501
from repro_torch.runtime.inference import InferenceEngine, freeze  # noqa: E402,E501
from repro_torch.runtime.resilience import (  # noqa: E402
    ARTIFACT_FILE, DeadlineExceededError, DrainingError, EngineSupervisor,
    OverloadedError, RetriesExhaustedError, save_deployed, validate_artifact,
)
from repro_torch.testing import (  # noqa: E402
    CrashingEngine, FlakyEngine, kill_replica,
)

CPU = "cpu"


def _digits(b, shape=(28, 28), seed=0):
    return np.random.default_rng(seed).random((b,) + shape, np.float32)


def _model(seed=0, **kw):
    kw.setdefault("n", 32)
    kw.setdefault("depth", 2)
    kw.setdefault("distance", 0.05)
    kw.setdefault("det_size", 6)
    kw.setdefault("name", "fleet")
    model = build_model(DONNConfig(**kw), device=CPU)
    return model, model.init(torch.Generator().manual_seed(seed))


def _engine(dep, buckets):
    return InferenceEngine(dep, buckets=buckets, device=CPU)


class FakeEngine:
    """Engine-like double: deterministic row sums, optional stall."""

    buckets = (1, 2, 4, 8)
    deployed = None

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.group_sizes = []

    def infer(self, x):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.group_sizes.append(int(x.shape[0]))
        return np.sum(np.asarray(x), axis=(1, 2))[:, None]


class PoisonEngine(FakeEngine):
    """Fails any group containing the poison marker value."""

    MARKER = -777.0

    def infer(self, x):
        if np.any(np.asarray(x) == self.MARKER):
            raise RuntimeError("poison request in group")
        return super().infer(x)


def _submit_all(router, xs, timeout_ms=None):
    return [router.submit(x, timeout_ms=timeout_ms) for x in xs]


def _results(futs, timeout=30):
    return [f.result(timeout=timeout) for f in futs]


# --------------------------------------------------------------------------
# Continuous admission
# --------------------------------------------------------------------------
class TestContinuousAdmission:
    def test_idle_engine_dispatches_immediately(self):
        eng = FakeEngine()
        cb = ContinuousBatcher(eng, validate=False)
        try:
            f = cb.submit(np.ones((4, 4), np.float32))
            assert np.allclose(f.result(timeout=10), 16.0)
            assert eng.group_sizes[0] == 1  # no deadline was waited out
        finally:
            assert cb.close()

    def test_arrivals_coalesce_into_open_slot(self):
        eng = FakeEngine(delay_s=0.15)
        cb = ContinuousBatcher(eng, validate=False)
        try:
            first = cb.submit(np.zeros((4, 4), np.float32))
            time.sleep(0.05)  # first is in flight; these join the open slot
            rest = _submit_all(
                cb, [np.full((4, 4), i, np.float32) for i in range(1, 5)])
            outs = _results([first] + rest)
            assert all(np.allclose(o, 16.0 * i) for i, o in enumerate(outs))
            assert eng.group_sizes == [1, 4]  # the 4 rode one dispatch
        finally:
            cb.close()

    def test_groups_respect_bucket_max(self):
        eng = FakeEngine(delay_s=0.1)
        cb = ContinuousBatcher(eng, validate=False)
        try:
            first = cb.submit(np.zeros((4, 4), np.float32))
            time.sleep(0.03)
            rest = _submit_all(
                cb, [np.zeros((4, 4), np.float32) for _ in range(12)])
            _results([first] + rest)
            assert all(g <= max(eng.buckets) for g in eng.group_sizes)
        finally:
            cb.close()

    def test_submit_during_drain_typed_rejection(self):
        eng = FakeEngine(delay_s=0.05)
        cb = ContinuousBatcher(eng, validate=False)
        try:
            futs = _submit_all(
                cb, [np.zeros((4, 4), np.float32) for _ in range(6)])
            done = threading.Event()
            drained = {}

            def drain():
                drained["ok"] = cb.drain(timeout=20)
                done.set()

            threading.Thread(target=drain, daemon=True).start()
            time.sleep(0.01)
            with pytest.raises(DrainingError):
                cb.submit(np.zeros((4, 4), np.float32))
            assert done.wait(20) and drained["ok"]
            _results(futs)  # the drain flushed everything admitted
            assert cb.stats()["rejected_draining"] == 1
            cb.resume()
            f = cb.submit(np.ones((4, 4), np.float32))
            assert np.allclose(f.result(timeout=10), 16.0)
        finally:
            cb.close()

    def test_deadline_expiry_while_queued_in_open_slot(self):
        eng = FakeEngine(delay_s=0.4)
        cb = ContinuousBatcher(eng, validate=False)
        try:
            blocker = cb.submit(np.zeros((4, 4), np.float32))
            time.sleep(0.1)  # blocker dispatched; the engine is busy
            doomed = cb.submit(np.ones((4, 4), np.float32), timeout_ms=50)
            ok = cb.submit(np.full((4, 4), 2.0, np.float32))
            with pytest.raises(DeadlineExceededError):
                doomed.result(timeout=10)
            assert np.allclose(ok.result(timeout=10), 32.0)
            assert np.allclose(blocker.result(timeout=10), 0.0)
            assert cb.stats()["expired"] == 1
        finally:
            cb.close()

    def test_admission_bound_sheds_typed(self):
        eng = FakeEngine(delay_s=0.2)
        cb = ContinuousBatcher(eng, validate=False, max_queue=2)
        try:
            first = cb.submit(np.zeros((4, 4), np.float32))
            time.sleep(0.05)
            kept = _submit_all(
                cb, [np.zeros((4, 4), np.float32) for _ in range(2)])
            with pytest.raises(OverloadedError):
                cb.submit(np.zeros((4, 4), np.float32))
            _results([first] + kept)
            assert cb.stats()["shed"] == 1
        finally:
            cb.close()

    def test_request_validation_at_the_door(self):
        model, params = _model()
        dep = freeze(model, params, device=CPU)
        cb = ContinuousBatcher(_engine(dep, (1, 2)))
        try:
            with pytest.raises(ValueError):
                cb.submit(np.zeros((3, 3), np.float32))
            with pytest.raises(TypeError):
                cb.submit(np.zeros((28, 28), dtype="U4"))
        finally:
            cb.close()


# --------------------------------------------------------------------------
# Fleet failover
# --------------------------------------------------------------------------
class TestFleetFailover:
    def test_midrun_kill_zero_drops_bit_identical(self):
        model, params = _model()
        dep = freeze(model, params, device=CPU)
        xs = _digits(24)
        ref = _engine(dep, (8,)).infer(xs)
        router = FleetRouter([FlakyEngine(_engine(dep, (8,))),
                              FlakyEngine(_engine(dep, (8,)))],
                             seed=3, backoff_base_ms=1.0)
        try:
            futs = _submit_all(router, list(xs))
            kill_replica(router)  # mid-run crash: stays down
            outs = np.stack(_results(futs))
            np.testing.assert_array_equal(outs, ref)
            s = router.stats()
            assert s["served"] == 24 and s["failed"] == 0
        finally:
            router.close()

    def test_n_minus_1_failures_still_serve(self):
        engines = [CrashingEngine(FakeEngine(), crash_after=0)
                   for _ in range(2)] + [FakeEngine()]
        router = FleetRouter(engines, seed=1, backoff_base_ms=1.0,
                             validate=False)
        try:
            futs = _submit_all(
                router, [np.full((4, 4), i, np.float32) for i in range(16)])
            outs = _results(futs)
            assert all(np.allclose(o, 16.0 * i) for i, o in enumerate(outs))
            s = router.stats()
            assert s["failed"] == 0
            assert s["replica_failures"] >= 1  # the dead replicas were hit
        finally:
            router.close()

    def test_poison_request_fails_alone(self):
        eng = PoisonEngine(delay_s=0.1)
        router = FleetRouter([eng], seed=2, max_retries=1,
                             backoff_base_ms=1.0, validate=False)
        try:
            blocker = router.submit(np.zeros((4, 4), np.float32))
            time.sleep(0.03)
            good = [np.full((4, 4), i, np.float32) for i in range(1, 6)]
            poison = np.full((4, 4), PoisonEngine.MARKER, np.float32)
            futs = _submit_all(router, good[:2] + [poison] + good[2:])
            assert np.allclose(blocker.result(timeout=30), 0.0)
            with pytest.raises(RetriesExhaustedError):
                futs[2].result(timeout=30)
            others = [f.result(timeout=30)
                      for i, f in enumerate(futs) if i != 2]
            expect = [16.0 * i for i in range(1, 6)]
            assert all(np.allclose(o, e) for o, e in zip(others, expect))
            s = router.stats()
            assert s["failed"] == 1 and s["served"] == 6
            assert s["splits"] >= 1  # the poison isolated via group splits
        finally:
            router.close()

    def test_retry_exhaustion_is_typed_and_bounded(self):
        dead = CrashingEngine(FakeEngine(), crash_after=0)
        router = FleetRouter([dead], max_retries=2, backoff_base_ms=1.0,
                             seed=4, validate=False)
        try:
            f = router.submit(np.zeros((4, 4), np.float32))
            with pytest.raises(RetriesExhaustedError):
                f.result(timeout=30)
            s = router.stats()
            assert s["failed"] == 1
            assert s["replica_failures"] == 3  # 1 dispatch + 2 retries
        finally:
            router.close()

    def test_least_loaded_placement_spreads_over_idle_replicas(self):
        e1, e2 = FakeEngine(delay_s=0.05), FakeEngine(delay_s=0.05)
        router = FleetRouter([e1, e2], validate=False)
        try:
            futs = _submit_all(
                router, [np.zeros((4, 4), np.float32) for _ in range(16)])
            _results(futs)
            assert e1.group_sizes and e2.group_sizes  # both served
        finally:
            router.close()

    def test_unclean_close_fails_stranded_futures(self):
        dead = CrashingEngine(FakeEngine(), crash_after=0)
        router = FleetRouter([dead], max_retries=50,
                             backoff_base_ms=200.0, backoff_max_ms=5000.0,
                             seed=5, validate=False)
        f = router.submit(np.zeros((4, 4), np.float32))
        assert not router.close(timeout=0.3)
        with pytest.raises(RuntimeError):
            f.result(timeout=10)

    def test_many_submitters_lose_no_request(self):
        """Eight replicas and twelve submitting threads, the interpreter
        switching threads every microsecond: every request is served
        once, with its own output, and the counters lose no update."""
        engines = [FakeEngine() for _ in range(8)]
        router = FleetRouter(engines, validate=False, max_queue=None)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        got = {}
        try:
            def client(c):
                futs = [(c * 100 + i, router.submit(
                    np.full((4, 4), c * 100 + i, np.float32)))
                    for i in range(40)]
                for k, f in futs:
                    got[k] = float(f.result(timeout=60)[0])

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
            assert router.close()
        assert len(got) == 480
        assert all(v == 16.0 * k for k, v in got.items())
        s = router.stats()
        assert s["submitted"] == s["served"] == 480
        assert sum(sum(e.group_sizes) for e in engines) == 480


# --------------------------------------------------------------------------
# Drain + warm swap from artifacts
# --------------------------------------------------------------------------
class TestDrainAndSwap:
    def _two_artifacts(self, tmp_path):
        model, p0 = _model(seed=0)
        _, p1 = _model(seed=1)
        d0, d1 = freeze(model, p0, device=CPU), freeze(model, p1, device=CPU)
        a0, a1 = tmp_path / "art0", tmp_path / "art1"
        save_deployed(d0, a0)
        save_deployed(d1, a1)
        return d0, d1, a0, a1

    def test_from_artifact_serves_and_swaps_zero_drops(self, tmp_path):
        d0, d1, a0, a1 = self._two_artifacts(tmp_path)
        xs = _digits(8)
        ref0 = _engine(d0, (8,)).infer(xs)
        ref1 = _engine(d1, (8,)).infer(xs)
        assert not np.array_equal(ref0, ref1)  # the swap is observable
        # single serving bucket: every group pads to the same batch, so
        # per-row outputs are bit-comparable to the reference
        router = FleetRouter.from_artifact(a0, replicas=2, buckets=(8,),
                                           device=CPU)
        try:
            np.testing.assert_array_equal(
                np.stack(_results(_submit_all(router, list(xs)))), ref0)
            stop = threading.Event()
            live, errs = [], []

            def pump():
                while not stop.is_set():
                    try:
                        live.append(router.submit(xs[0]))
                    except DrainingError:
                        errs.append("draining")  # rolling swap never drains
                    time.sleep(0.002)

            t = threading.Thread(target=pump, daemon=True)
            t.start()
            meta = router.swap_artifact(a1, rolling=True)
            stop.set()
            t.join(timeout=10)
            assert meta["format"] >= 2 and not errs
            for o in _results(live):  # each served by one of the models
                assert (np.array_equal(o, ref0[0])
                        or np.array_equal(o, ref1[0]))
            np.testing.assert_array_equal(
                np.stack(_results(_submit_all(router, list(xs)))), ref1)
            assert router.stats()["failed"] == 0
            assert router.stats()["swaps"] == 1
        finally:
            router.close()

    def test_swap_validates_before_touching_replicas(self, tmp_path):
        d0, _, a0, _ = self._two_artifacts(tmp_path)
        router = FleetRouter.from_artifact(a0, replicas=1, buckets=(1, 4),
                                           device=CPU)
        try:
            bad = tmp_path / "nonsense"
            bad.mkdir()
            with pytest.raises(FileNotFoundError):
                router.swap_artifact(bad)
            x = _digits(1)[0]
            ref = _engine(d0, (1,)).infer(x[None])[0]
            np.testing.assert_array_equal(
                router.submit(x).result(timeout=30), ref)
        finally:
            router.close()

    def test_swap_requires_build_factories(self, tmp_path):
        _, _, a0, _ = self._two_artifacts(tmp_path)
        router = FleetRouter([FakeEngine()], validate=False)
        try:
            with pytest.raises(RuntimeError, match="build factory"):
                router.swap_artifact(a0)
        finally:
            router.close()

    def test_nonrolling_swap_drains_then_resumes(self, tmp_path):
        _, d1, a0, a1 = self._two_artifacts(tmp_path)
        router = FleetRouter.from_artifact(a0, replicas=1, buckets=(1, 4),
                                           device=CPU)
        try:
            router.swap_artifact(a1, rolling=False)
            assert not router.draining  # admission reopened
            x = _digits(1)[0]
            ref = _engine(d1, (1,)).infer(x[None])[0]
            np.testing.assert_array_equal(
                router.submit(x).result(timeout=30), ref)
        finally:
            router.close()

    def test_from_artifact_warms_every_bucket_of_every_replica(self,
                                                                tmp_path):
        _, _, a0, _ = self._two_artifacts(tmp_path)
        router = FleetRouter.from_artifact(a0, replicas=3, buckets=(1, 4),
                                           device=CPU)
        try:
            for rep in router.replicas:
                sup = rep.engine
                assert sup.ready and sup.device.type == "cpu"
                assert sup.engine.device.type == "cpu"
        finally:
            router.close()


# --------------------------------------------------------------------------
# Artifact pre-validation
# --------------------------------------------------------------------------
class TestValidateArtifact:
    def test_good_artifact_passes(self, tmp_path):
        model, params = _model()
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        assert validate_artifact(tmp_path)["family"] == "cls"

    def test_missing_dir_and_manifest(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            validate_artifact(tmp_path / "nope")
        (tmp_path / "empty").mkdir()
        with pytest.raises(FileNotFoundError):
            validate_artifact(tmp_path / "empty")

    def test_unknown_format_rejected(self, tmp_path):
        import json

        model, params = _model()
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        mpath = tmp_path / ARTIFACT_FILE
        meta = json.loads(mpath.read_text())
        meta["format"] = 99
        mpath.write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="format"):
            validate_artifact(tmp_path)

    def test_broken_spec_rejected(self, tmp_path):
        import json

        model, params = _model()
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        mpath = tmp_path / ARTIFACT_FILE
        meta = json.loads(mpath.read_text())
        meta["spec"]["n"] = -4
        mpath.write_text(json.dumps(meta))
        with pytest.raises(ValueError):
            validate_artifact(tmp_path)


# --------------------------------------------------------------------------
# Supervisor restart backoff
# --------------------------------------------------------------------------
class TestSupervisorBackoff:
    def test_backoff_schedule_exponential_capped(self):
        sup = EngineSupervisor("/nonexistent", backoff_base_ms=10.0,
                               backoff_max_ms=40.0, backoff_jitter=0.0,
                               seed=0, device=CPU)
        waits = [sup.restart_backoff_s(a) for a in (1, 2, 3, 4, 5)]
        assert waits == [0.01, 0.02, 0.04, 0.04, 0.04]
        jittered = EngineSupervisor("/nonexistent", backoff_base_ms=10.0,
                                    backoff_jitter=0.5, seed=0, device=CPU)
        w = jittered.restart_backoff_s(1)
        assert 0.01 <= w <= 0.015

    def test_restart_records_history(self, tmp_path):
        model, params = _model()
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        engines = []

        def factory(deployed):
            eng = FlakyEngine(_engine(deployed, (1,)))
            engines.append(eng)
            return eng

        sup = EngineSupervisor(tmp_path, engine_factory=factory,
                               max_restarts=2, backoff_base_ms=1.0,
                               seed=0, device=CPU).start()
        engines[-1].kill()
        sup.infer(_digits(1)[0])  # restart + retry succeeds
        hist = sup.stats()["restart_history"]
        assert len(hist) == 1
        assert hist[0]["attempt"] == 1
        assert hist[0]["backoff_s"] >= 0.001
        assert hist[0]["rebuild_s"] > 0


# --------------------------------------------------------------------------
# Fault injectors
# --------------------------------------------------------------------------
class TestCrashInjectors:
    def test_crashing_engine_dies_after_k_and_stays_dead(self):
        eng = CrashingEngine(FakeEngine(), crash_after=2)
        x = np.zeros((1, 4, 4), np.float32)
        eng.infer(x)
        eng.infer(x)
        with pytest.raises(RuntimeError):
            eng.infer(x)
        with pytest.raises(RuntimeError):
            eng.infer(x)  # permanently down, unlike FlakyEngine

    def test_crash_on_drain_arms_lazily(self):
        eng = CrashingEngine(FakeEngine(), crash_after=1,
                             crash_on_drain=True)
        x = np.zeros((1, 4, 4), np.float32)
        for _ in range(5):
            eng.infer(x)  # unarmed: unlimited calls
        eng.arm()
        eng.infer(x)
        with pytest.raises(RuntimeError):
            eng.infer(x)

    def test_kill_replica_picks_first_killable(self):
        killable = FlakyEngine(FakeEngine())
        router = FleetRouter([FakeEngine(), killable], validate=False)
        try:
            assert kill_replica(router) is killable
            with pytest.raises(ValueError):
                kill_replica(router)  # no live killable replica left
        finally:
            router.close()
