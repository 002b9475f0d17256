"""The port's persistence slice on the CPU: checkpoint store, artifacts,
supervision, training rollback and frozen-plane faults.

Mirrors the reference's ``tests/test_checkpoint.py`` and
``tests/test_resilience.py`` class for class at their small sizes, and
holds the two packages to one on-disk format:

- a JAX-written artifact (cls, multi, seg and heterogeneous; f32, bf16 and
  int8 planes; ``rfft_first``; both ``use_pallas`` settings, the JAX side
  in interpret mode) cold-starts in the port, and the port's in JAX: the
  planes arrive bit for bit and the outputs agree within RTOL of the max
  with argmax equal;
- a checkpoint of an AdamW-shaped tree written by either package restores
  in the other with equal values and the same leaf names;
- ``perturb_frozen`` gives the reference's planes bit for bit on the same
  planes and seed;
- the committed JAX-written fixture (``tests/fixtures/jax_artifact_n64``)
  serves its committed JAX outputs.

Every port entry point gets ``device="cpu"`` (they default to the card).
"""
import dataclasses
import functools
import json
import pathlib
import threading
import time
import weakref

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core import build_model as jbuild  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.runtime import inference as jinf  # noqa: E402
from repro.runtime import resilience as jres  # noqa: E402
from repro.testing import perturb_frozen as jperturb  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.models import build_model  # noqa: E402
from repro_torch.core.train_utils import train_classifier  # noqa: E402
from repro_torch.data.synthetic import batch_iterator, synth_digits  # noqa: E402,E501
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)
from repro_torch.runtime.resilience import (  # noqa: E402
    ARTIFACT_FILE, PLANES_DIR, DeadlineExceededError, EngineSupervisor,
    OverloadedError, load_deployed, save_deployed, validate_artifact,
)
from repro_torch.testing import (  # noqa: E402
    FlakyEngine, SlowEngine, corrupt_chunk, flip_crc, perturb_frozen,
    poison_batches,
)
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

CPU = "cpu"
RTOL = 1e-5  # max|port - jax| / max|jax|, f32 (the reference's own)
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "jax_artifact_n64"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _digits(b, shape=(28, 28), seed=0):
    return np.random.default_rng(seed).random((b,) + shape, np.float32)


def _model(seed=0, **kw):
    kw.setdefault("n", 32)
    kw.setdefault("depth", 3)
    kw.setdefault("distance", 0.05)
    kw.setdefault("det_size", 6)
    model = build_model(DONNConfig(**kw), device=CPU)
    return model, model.init(torch.Generator().manual_seed(seed))


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# ==========================================================================
# Checkpoint store (the reference's tests/test_checkpoint.py)
# ==========================================================================
def _state(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(r.normal(size=(17, 5)),
                                     dtype=torch.float32),
                   "b": torch.tensor(r.normal(size=(5,)),
                                     dtype=torch.bfloat16)},
        "mu": {"w": torch.zeros((17, 5)), "b": torch.zeros((5,))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


class TestRoundtrip:
    def test_save_restore_identical(self, tmp_path):
        s = _state()
        ckpt.save(tmp_path, 7, s)
        _equal_trees(ckpt.restore(tmp_path, 7, s, device=CPU), s)

    def test_latest_pointer(self, tmp_path):
        s = _state()
        ckpt.save(tmp_path, 3, s)
        ckpt.save(tmp_path, 9, s)
        assert ckpt.latest_step(tmp_path) == 9

    def test_chunked_large_leaf(self, tmp_path, monkeypatch):
        monkeypatch.setattr(store, "CHUNK_BYTES", 256)
        s = {"big": torch.arange(1000, dtype=torch.float32).reshape(100, 10)}
        store.save(tmp_path, 1, s)
        files = list((tmp_path / "step_00000001").glob("leaf_00000.c*.npy"))
        assert len(files) > 1  # actually chunked
        r = store.restore(tmp_path, 1, s, device=CPU)
        assert torch.equal(r["big"], s["big"])

    @pytest.mark.parametrize("seed", [0, 7, 19, 33, 50])
    def test_random_trees(self, tmp_path, seed):
        r = np.random.default_rng(seed)
        tree = {
            f"k{i}": torch.tensor(r.normal(size=tuple(r.integers(1, 7, 2))),
                                  dtype=torch.float32)
            for i in range(int(r.integers(1, 5)))
        }
        ckpt.save(tmp_path / f"h{seed}", 0, tree)
        _equal_trees(ckpt.restore(tmp_path / f"h{seed}", 0, tree,
                                  device=CPU), tree)

    def test_bf16_is_stored_as_raw_words_under_its_name(self, tmp_path):
        b = torch.tensor([1.0, -2.5, 3.140625, 1e-3], dtype=torch.bfloat16)
        ckpt.save(tmp_path, 0, {"b": b})
        d = tmp_path / "step_00000000"
        entry = json.loads((d / "MANIFEST.json").read_text())["leaves"][0]
        assert entry["dtype"] == "bfloat16" and entry["name"] == "['b']"
        raw = np.load(d / "leaf_00000.c000.npy")
        assert raw.dtype == np.uint8
        assert raw.tobytes() == b.view(torch.int16).numpy().tobytes()

    def test_tree_paths_are_jax_keystr(self):
        p = {"phase": {"layer_1": torch.zeros(2), "layer_0": torch.zeros(2)}}
        tree = {"params": p, "opt": AdamW().init(p),
                "t": (torch.zeros(1), [torch.zeros(1), torch.zeros(1)]),
                "opt_step": torch.tensor(0)}
        jp = {"phase": {"layer_1": jnp.zeros(2), "layer_0": jnp.zeros(2)}}
        jtree = {"params": jp, "opt": JAdamW().init(jp),
                 "t": (jnp.zeros(1), [jnp.zeros(1), jnp.zeros(1)]),
                 "opt_step": jnp.asarray(0)}
        want = [jax.tree_util.keystr(kp) for kp, _ in
                jax.tree_util.tree_flatten_with_path(jtree)[0]]
        assert tree_paths(tree) == want
        assert "['opt'].mu['phase']['layer_0']" in want


class TestDurability:
    def test_gc_keeps_last_k(self, tmp_path):
        s = _state()
        for i in range(6):
            ckpt.save(tmp_path, i, s, keep=2)
        dirs = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
        assert dirs == ["step_00000004", "step_00000005"]

    def test_partial_tmp_dir_is_ignored(self, tmp_path):
        s = _state()
        ckpt.save(tmp_path, 1, s)
        (tmp_path / "step_00000002.tmp").mkdir()  # a crash mid-write
        (tmp_path / "step_00000002.tmp" / "leaf_00000.c000.npy").write_bytes(
            b"garbage")
        assert ckpt.latest_step(tmp_path) == 1
        r = ckpt.restore(tmp_path, 1, s, device=CPU)
        assert int(r["step"]) == 7

    def _flip_first_chunk(self, tmp_path):
        f = sorted((tmp_path / "step_00000001").glob("*.npy"))[0]
        data = bytearray(f.read_bytes())
        data[-4] ^= 0xFF
        f.write_bytes(bytes(data))

    def test_corruption_detected(self, tmp_path):
        s = _state()
        ckpt.save(tmp_path, 1, s)
        self._flip_first_chunk(tmp_path)
        with pytest.raises(IOError):
            ckpt.restore(tmp_path, 1, s, verify=True, device=CPU)

    def test_corruption_detected_by_default(self, tmp_path):
        s = _state()
        ckpt.save(tmp_path, 1, s)
        self._flip_first_chunk(tmp_path)
        with pytest.raises(IOError):
            ckpt.restore(tmp_path, 1, s, device=CPU)

    def test_structure_mismatch_raises(self, tmp_path):
        s = _state()
        ckpt.save(tmp_path, 1, s)
        with pytest.raises(ValueError):
            ckpt.restore(tmp_path, 1, {"only": torch.zeros(3)}, device=CPU)


class TestAsync:
    def test_async_commit(self, tmp_path):
        s = _state()
        saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
        for i in range(3):
            saver.save(i, s)
        saver.wait()
        assert ckpt.latest_step(tmp_path) == 2

    def test_async_snapshot_consistency(self, tmp_path):
        """Rebinding the state after save() must not affect the snapshot."""
        s = {"w": torch.ones(4)}
        saver = ckpt.AsyncCheckpointer(tmp_path)
        saver.save(0, s)
        s["w"] = s["w"] * 100
        saver.wait()
        r = ckpt.restore(tmp_path, 0, s, device=CPU)
        assert torch.equal(r["w"], torch.ones(4))

    def test_async_snapshot_survives_in_place_mutation(self, tmp_path):
        """torch tensors are mutable and ``.cpu()`` of a CPU tensor is the
        same storage: the snapshot must be a real copy taken by save()."""
        w = torch.ones(1 << 16)
        saver = ckpt.AsyncCheckpointer(tmp_path)
        saver.save(0, {"w": w})
        w.mul_(100)  # the caller's tensor, changed in place at once
        saver.wait()
        r = ckpt.restore(tmp_path, 0, {"w": w}, device=CPU)
        assert torch.equal(r["w"], torch.ones(1 << 16))

    def test_async_worker_error_reraised(self, tmp_path):
        blocker = tmp_path / "blocker"
        blocker.write_text("a file where the ckpt dir should go")
        saver = ckpt.AsyncCheckpointer(blocker / "ck")
        s = {"w": torch.ones(4)}
        saver.save(0, s)  # worker fails: parent path is a file
        with pytest.raises(OSError):
            saver.save(1, s)
        saver.wait()  # the error is consumed once


def _adamw_trees(seed=0):
    """One AdamW-shaped training state for each package, same values."""
    r = np.random.default_rng(seed)
    phase = {f"layer_{i}": r.normal(size=(6, 5)).astype(np.float32)
             for i in (1, 0, 2)}
    mom = {k: r.normal(size=v.shape).astype(np.float32)
           for k, v in phase.items()}
    bf = r.normal(size=(3, 4)).astype(np.float32)
    t = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}  # noqa: E731,E501
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    gen = torch.Generator().manual_seed(seed)
    port = {"params": {"phase": t(phase)},
            "opt": AdamW().init({"phase": t(phase)})._replace(
                mu={"phase": t(mom)}),
            "rng": gen.get_state(),
            "opt_step": torch.tensor(5, dtype=torch.int32),
            "bf": torch.from_numpy(bf).to(torch.bfloat16)}
    ref = {"params": {"phase": j(phase)},
           "opt": JAdamW().init({"phase": j(phase)})._replace(
               mu={"phase": j(mom)}),
           "rng": jnp.asarray(gen.get_state().numpy()),
           "opt_step": jnp.asarray(5, jnp.int32),
           "bf": jnp.asarray(bf).astype(jnp.bfloat16)}
    return port, ref


class TestCrossPackageCheckpoint:
    def test_jax_written_state_restores_in_the_port(self, tmp_path):
        port, ref = _adamw_trees(1)
        jckpt.save(tmp_path, 3, ref)
        got = ckpt.restore(tmp_path, 3, port, device=CPU)
        assert type(got["opt"]).__name__ == "AdamWState"
        _equal_trees(got, port)

    def test_port_written_state_restores_in_jax(self, tmp_path):
        port, ref = _adamw_trees(2)
        ckpt.save(tmp_path, 4, port)
        got = jckpt.restore(tmp_path, 4, ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))

    def test_both_packages_write_the_same_manifest(self, tmp_path):
        port, ref = _adamw_trees(3)
        ckpt.save(tmp_path / "port", 0, port)
        jckpt.save(tmp_path / "jax", 0, ref)
        m = [json.loads((tmp_path / w / "step_00000000" / "MANIFEST.json")
                        .read_text()) for w in ("port", "jax")]
        assert m[0] == m[1]  # names, dtypes, shapes, chunking and crc32


# ==========================================================================
# Serialized frozen artifacts (the reference's TestArtifactRoundTrip)
# ==========================================================================
class TestArtifactRoundTrip:
    @pytest.mark.parametrize("kw", [
        dict(name="ar-qat", codesign="qat"),
        dict(name="ar-pl", depth=2, codesign="qat", use_pallas=True),
    ])
    def test_save_load_bit_identical(self, tmp_path, kw):
        model, params = _model(**kw)
        dep = freeze(model, params, device=CPU)
        x = _digits(2)
        ref = InferenceEngine(dep, buckets=(2,), device=CPU).infer(x)
        save_deployed(dep, tmp_path)
        dep2 = load_deployed(tmp_path, device=CPU)
        assert dep2.family == dep.family
        np.testing.assert_array_equal(
            InferenceEngine(dep2, buckets=(2,), device=CPU).infer(x), ref)

    @pytest.mark.parametrize("use_pallas", [False, True])
    @pytest.mark.parametrize("dtype,rfft", [
        ("float32", False), ("bfloat16", False), ("int8", False),
        ("float32", True), ("int8", True),
    ])
    def test_plane_dtypes_and_rfft_round_trip_bitwise(self, tmp_path,
                                                      use_pallas, dtype,
                                                      rfft):
        model, params = _model(name="ar-dt", depth=2, codesign="qat",
                               use_pallas=use_pallas)
        dep = freeze(model, params, plane_dtype=dtype, rfft_first=rfft,
                     device=CPU)
        x = _digits(3, seed=4)
        ref = InferenceEngine(dep, buckets=(4,), device=CPU).infer(x)
        save_deployed(dep, tmp_path)
        dep2 = load_deployed(tmp_path, device=CPU)
        assert (dep2.plane_dtype, dep2.rfft_first) == (dtype, rfft)
        assert len(dep2.frozen) == (4 if dtype == "int8" else 2)
        for a, b in zip(dep2.frozen, dep.frozen):
            assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(
            InferenceEngine(dep2, buckets=(4,), device=CPU).infer(x), ref)

    def test_heterogeneous_roundtrip(self, tmp_path):
        model, params = _model(
            name="ar-het",
            layers=(LayerSpec(0.05, size=40), LayerSpec(0.05, size=40),
                    LayerSpec(0.05, codesign="qat", device_levels=4)),
        )
        dep = freeze(model, params, device=CPU)
        x = _digits(2)
        ref = InferenceEngine(dep, buckets=(2,), device=CPU).infer(x)
        save_deployed(dep, tmp_path)
        dep2 = load_deployed(tmp_path, device=CPU)
        assert dep2.heterogeneous and len(dep2.frozen) == len(dep.frozen)
        np.testing.assert_array_equal(
            InferenceEngine(dep2, buckets=(2,), device=CPU).infer(x), ref)

    def test_multi_channel_roundtrip(self, tmp_path):
        model, params = _model(name="ar-rgb", channels=3, det_size=4)
        dep = freeze(model, params, device=CPU)
        x = _digits(2, shape=(3, 28, 28))
        ref = InferenceEngine(dep, buckets=(2,), device=CPU).infer(x)
        save_deployed(dep, tmp_path)
        np.testing.assert_array_equal(
            InferenceEngine(load_deployed(tmp_path, device=CPU),
                            buckets=(2,), device=CPU).infer(x), ref)

    def test_corrupt_chunk_rejected_at_load(self, tmp_path):
        model, params = _model(name="ar-rot")
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        corrupt_chunk(tmp_path / PLANES_DIR, 0)
        with pytest.raises(IOError):
            load_deployed(tmp_path, device=CPU)

    def test_flipped_crc_rejected_at_load(self, tmp_path):
        model, params = _model(name="ar-crc")
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        flip_crc(tmp_path / PLANES_DIR, 0)
        with pytest.raises(IOError):
            load_deployed(tmp_path, device=CPU)

    def test_missing_and_foreign_artifacts_rejected(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_deployed(tmp_path / "nope", device=CPU)
        model, params = _model(name="ar-fmt")
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        meta_path = tmp_path / ARTIFACT_FILE
        meta = json.loads(meta_path.read_text())
        meta["format"] = 99
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(ValueError):
            load_deployed(tmp_path, device=CPU)


# ==========================================================================
# Artifacts across the two packages
# ==========================================================================
FAMILY_KW = {
    "cls": dict(name="x-cls", codesign="qat"),
    "multi": dict(name="x-rgb", channels=3, num_classes=6, codesign="qat"),
    "seg": dict(name="x-seg", segmentation=True, skip_from=0,
                layer_norm=True, codesign="qat"),
    "hetero": dict(name="x-het", n=40, det_size=4, depth=3,
                   layers=(LayerSpec(0.05, size=40), LayerSpec(0.05, size=40),
                           LayerSpec(0.05, codesign="qat",
                                     device_levels=4))),
}
CROSS_CASES = [  # (family, use_pallas, plane dtype, rfft_first)
    ("cls", False, "float32", False), ("cls", True, "float32", False),
    ("cls", False, "bfloat16", False), ("cls", True, "bfloat16", False),
    ("cls", False, "int8", False), ("cls", True, "int8", False),
    ("cls", False, "float32", True), ("cls", True, "float32", True),
    ("cls", True, "int8", True),
    ("multi", False, "float32", False), ("multi", True, "float32", False),
    ("multi", True, "int8", False), ("multi", True, "float32", True),
    ("seg", False, "float32", False), ("seg", True, "float32", False),
    ("seg", True, "bfloat16", False), ("seg", True, "float32", True),
    ("hetero", False, "float32", False), ("hetero", True, "float32", False),
    ("hetero", True, "int8", False),
]


def _jax_cfg(tcfg: DONNConfig):
    d = dataclasses.asdict(tcfg)
    if tcfg.layers is not None:
        d["layers"] = tuple(jconfig.LayerSpec(**l) for l in d["layers"])
    return jconfig.DONNConfig(**d)


@functools.lru_cache(maxsize=None)
def _pair(family: str, use_pallas: bool):
    """(port model, port params, jax model, jax params), one config."""
    kw = {"n": 32, "depth": 2, "distance": 0.05, "det_size": 6,
          "gamma": 1.1, **FAMILY_KW[family]}
    tcfg = DONNConfig(use_pallas=use_pallas, **kw)
    jm = jbuild(_jax_cfg(tcfg))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device=CPU)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return tm, tp, jm, jp


def _family_input(family, b, seed):
    shape = (3, 28, 28) if family == "multi" else (28, 28)
    return _digits(b, shape=shape, seed=seed)


def _hold_outputs(got, want, family):
    assert _rel(got, want) <= RTOL
    if family not in ("seg",):
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _hold_planes_bitwise(port_frozen, jax_frozen):
    pl, jl = tree_leaves(port_frozen), jax.tree.leaves(jax_frozen)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        j = np.asarray(j)
        assert str(p.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(p.float().numpy(),
                                      j.astype(np.float32))


@pytest.mark.parametrize("family,use_pallas,dtype,rfft", CROSS_CASES)
def test_port_cold_starts_a_jax_written_artifact(tmp_path, family,
                                                 use_pallas, dtype, rfft):
    _, _, jm, jp = _pair(family, use_pallas)
    x = _family_input(family, 4, seed=2)
    jdep = jinf.freeze(jm, jp, plane_dtype=dtype, rfft_first=rfft)
    want = np.asarray(jax.jit(jdep.forward)(jnp.asarray(x)))
    jres.save_deployed(jdep, tmp_path)
    dep = load_deployed(tmp_path, device=CPU)
    assert (dep.family, dep.plane_dtype, dep.rfft_first) == (
        jdep.family, dtype, rfft)
    assert dep.cfg.use_pallas is use_pallas  # the plane convention
    _hold_planes_bitwise(dep.frozen, jdep.frozen)
    got = InferenceEngine(dep, buckets=(4,), device=CPU).infer(x)
    _hold_outputs(got, want, family)


@pytest.mark.parametrize("family,use_pallas,dtype,rfft", CROSS_CASES)
def test_jax_cold_starts_a_port_written_artifact(tmp_path, family,
                                                 use_pallas, dtype, rfft):
    tm, tp, _, _ = _pair(family, use_pallas)
    x = _family_input(family, 4, seed=3)
    dep = freeze(tm, tp, plane_dtype=dtype, rfft_first=rfft, device=CPU)
    got = InferenceEngine(dep, buckets=(4,), device=CPU).infer(x)
    save_deployed(dep, tmp_path)
    assert jres.validate_artifact(tmp_path)["family"] == dep.family
    jdep = jres.load_deployed(tmp_path)
    assert (jdep.plane_dtype, jdep.rfft_first) == (dtype, rfft)
    _hold_planes_bitwise(dep.frozen, jdep.frozen)
    want = np.asarray(jax.jit(jdep.forward)(jnp.asarray(x)))
    _hold_outputs(got, want, family)


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
def test_committed_jax_fixture_serves_its_jax_outputs(variant):
    """The JAX-written fixture (scripts/write_jax_artifact_fixture.py)
    served by the port on the CPU, against the JAX outputs beside it."""
    meta = validate_artifact(FIXTURE / variant)
    assert meta["format"] == 2 and meta["spec"]["use_pallas"] is True
    dep = load_deployed(FIXTURE / variant, device=CPU)
    x = np.load(FIXTURE / "x.npy")
    want = np.load(FIXTURE / f"jax_out_{variant}.npy")
    got = InferenceEngine(dep, buckets=(8,), device=CPU).infer(x)
    assert got.shape == want.shape == (8, dep.cfg.num_classes)
    _hold_outputs(got, want, "cls")


def test_committed_fixture_is_small():
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert 0 < size < 300_000


# ==========================================================================
# Engine supervision (the reference's TestSupervisor)
# ==========================================================================
class TestSupervisor:
    def test_killed_engine_recovers_bit_identical(self, tmp_path):
        model, params = _model(name="sup", codesign="qat")
        dep = freeze(model, params, device=CPU)
        x = _digits(2)
        ref = InferenceEngine(dep, buckets=(2,), device=CPU).infer(x)
        save_deployed(dep, tmp_path)
        current = {}

        def factory(deployed):
            current["engine"] = FlakyEngine(
                InferenceEngine(deployed, buckets=(2,), device=CPU))
            return current["engine"]

        sup = EngineSupervisor(tmp_path, engine_factory=factory,
                               max_restarts=2, device=CPU).start()
        assert sup.ready and sup.health_check()
        np.testing.assert_array_equal(sup.infer(x), ref)
        current["engine"].kill()
        assert not sup.health_check()
        # the failed request restarts from disk and is retried once
        np.testing.assert_array_equal(sup.infer(x), ref)
        s = sup.stats()
        assert s["restarts"] == 1 and s["ready"]
        assert s["errors"] >= 1 and 0 < s["error_rate"] < 1

    def test_restart_budget_exhausted(self, tmp_path):
        model, params = _model(name="sup-b")
        save_deployed(freeze(model, params, device=CPU), tmp_path)

        def factory(deployed):
            eng = FlakyEngine(InferenceEngine(deployed, buckets=(1,),
                                              device=CPU))
            eng.kill()  # every replacement is born dead
            return eng

        sup = EngineSupervisor(tmp_path, engine_factory=factory,
                               max_restarts=0, device=CPU).start()
        with pytest.raises(RuntimeError):
            sup.infer(_digits(1)[0])
        assert not sup.ready

    def test_restart_frees_the_failed_deployment(self, tmp_path):
        """The failed engine and its deployment are gone once the restart
        returns — no garbage collection needed, nothing held twice."""
        model, params = _model(name="sup-m", depth=2)
        save_deployed(freeze(model, params, device=CPU), tmp_path)
        built = []

        def factory(deployed):
            built.append(weakref.ref(deployed))
            return FlakyEngine(InferenceEngine(deployed, buckets=(1,),
                                               device=CPU))

        sup = EngineSupervisor(tmp_path, engine_factory=factory,
                               max_restarts=3, backoff_base_ms=0,
                               device=CPU).start()
        x = _digits(1)
        ref = sup.infer(x)
        for cycle in range(3):
            sup.engine.kill()
            np.testing.assert_array_equal(sup.infer(x), ref)
            assert built[-2]() is None, f"cycle {cycle}: old deployment alive"
            assert built[-1]() is sup.engine.deployed
        assert sup.stats()["restarts"] == 3


# ==========================================================================
# Hardened micro-batching (the reference's TestMicroBatcherResilience)
# ==========================================================================
def _slow_batcher(delay_s: float, **kw):
    model, params = _model(name="mb-slow", depth=2)
    eng = InferenceEngine(freeze(model, params, device=CPU), buckets=(1,),
                          device=CPU)
    eng.warmup()
    return MicroBatcher(SlowEngine(eng, delay_s), **kw), model


class TestMicroBatcherResilience:
    def test_overload_sheds(self):
        mb, _ = _slow_batcher(0.3, max_wait_ms=1.0, max_queue=2)
        first = mb.submit(_digits(1)[0])
        time.sleep(0.1)  # the worker takes `first` in-flight
        admitted = [mb.submit(_digits(1, seed=s)[0]) for s in (1, 2)]
        with pytest.raises(OverloadedError):
            mb.submit(_digits(1, seed=3)[0])
        assert mb.stats["shed"] == 1
        for f in [first] + admitted:
            assert f.result(timeout=60) is not None
        assert mb.close()

    def test_deadline_fails_only_its_own_future(self):
        mb, model = _slow_batcher(0.3, max_wait_ms=1.0)
        blocker = mb.submit(_digits(1)[0])
        time.sleep(0.1)  # worker is now busy for ~0.3s
        ok = mb.submit(_digits(1, seed=1)[0])
        doomed = mb.submit(_digits(1, seed=2)[0], timeout_ms=50.0)
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=60)
        assert blocker.result(timeout=60).shape == (model.cfg.num_classes,)
        assert ok.result(timeout=60).shape == (model.cfg.num_classes,)
        assert mb.stats["expired"] == 1
        mb.close()

    def test_unclean_close_fails_stranded_futures(self):
        mb, _ = _slow_batcher(2.0, max_wait_ms=1.0)
        inflight = mb.submit(_digits(1)[0])
        time.sleep(0.1)
        pending = mb.submit(_digits(1, seed=1)[0])
        assert mb.close(timeout=0.2) is False  # worker wedged in the call
        for f in (inflight, pending):
            with pytest.raises(RuntimeError):
                f.result(timeout=1)

    def test_submit_after_close_raises(self):
        model, params = _model(name="mb-cl", depth=2)
        mb = MicroBatcher(InferenceEngine(freeze(model, params, device=CPU),
                                          buckets=(1,), device=CPU))
        assert mb.close()
        with pytest.raises(RuntimeError):
            mb.submit(_digits(1)[0])

    def test_concurrent_submit_many_threads(self):
        model, params = _model(name="mb-thr", codesign="qat")
        eng = InferenceEngine(freeze(model, params, device=CPU),
                              buckets=(2, 8), device=CPU)
        eng.warmup()
        mb = MicroBatcher(eng, max_wait_ms=2.0)
        x = _digits(24, seed=11)
        results = np.zeros((24, model.cfg.num_classes), np.float32)

        def worker(lo):
            futs = [(i, mb.submit(x[i])) for i in range(lo, lo + 6)]
            for i, f in futs:
                results[i] = f.result(timeout=60)

        threads = [threading.Thread(target=worker, args=(lo,))
                   for lo in range(0, 24, 6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert mb.close()
        with torch.no_grad():
            ref = model.apply(params, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(results, ref, rtol=1e-5, atol=1e-7)
        assert mb.stats["submitted"] == 24 and mb.stats["served"] == 24


# ==========================================================================
# Training guardrails: skip / rollback (the reference's TestTrainGuardrails)
# ==========================================================================
def _train(model, params, stream, steps, **kw):
    return train_classifier(model, params, stream, steps=steps, lr=0.2,
                            steps_per_call=4, prefetch=0, **kw)


def _stream(xs, ys, skip_steps=()):
    it = batch_iterator(xs, ys, 16, seed=1)
    return (b for i, b in enumerate(it) if i not in set(skip_steps))


class TestTrainGuardrails:
    def test_poisoned_step_skipped_bit_identical(self):
        model, params = _model(name="tg-skip", codesign="qat")
        xs, ys = synth_digits(256, seed=0)
        res = _train(model, params,
                     poison_batches(_stream(xs, ys), [2]), 8, guard=True)
        assert res.skipped_steps == 1 and res.rollbacks == 0
        assert np.isnan(res.losses[2]) and len(res.losses) == 8
        ref = _train(model, params, _stream(xs, ys, skip_steps=[2]), 7)
        _equal_trees(res.params, ref.params)

    def test_fully_poisoned_chunk_rolls_back(self, tmp_path):
        """A whole-chunk NaN storm restores the last good checkpoint: the
        final params and every loss after the rollback equal a run that
        never saw those batches, bit for bit."""
        model, params = _model(name="tg-roll", codesign="qat")
        xs, ys = synth_digits(256, seed=0)
        res = _train(model, params,
                     poison_batches(_stream(xs, ys), [4, 5, 6, 7]), 12,
                     guard=True, ckpt_dir=tmp_path, ckpt_every=4)
        assert res.rollbacks == 1
        assert len(res.losses) == 8  # the rolled-back chunk's are dropped
        ref = _train(model, params,
                     _stream(xs, ys, skip_steps=[4, 5, 6, 7]), 8)
        assert res.losses == ref.losses and res.accs == ref.accs
        _equal_trees(res.params, ref.params)

    def test_rollback_restores_the_generator(self, tmp_path):
        """Gumbel codesign draws from a torch.Generator: its checkpointed
        state comes back at the rollback, so the draws after it are a
        clean run's."""
        model, params = _model(name="tg-rng", depth=2, codesign="gumbel",
                               device_levels=8)
        xs, ys = synth_digits(256, seed=0)
        run = lambda stream, steps, **kw: _train(  # noqa: E731
            model, params, stream, steps, needs_rng=True,
            rng=torch.Generator().manual_seed(5), **kw)
        res = run(poison_batches(_stream(xs, ys), [4, 5, 6, 7]), 12,
                  guard=True, ckpt_dir=tmp_path, ckpt_every=4)
        ref = run(_stream(xs, ys, skip_steps=[4, 5, 6, 7]), 8)
        assert res.rollbacks == 1 and res.losses == ref.losses
        _equal_trees(res.params, ref.params)

    def test_rollback_budget_exhausted_raises(self, tmp_path):
        model, params = _model(name="tg-bud", codesign="qat")
        xs, ys = synth_digits(256, seed=0)
        with pytest.raises(RuntimeError, match="rollback budget"):
            _train(model, params,
                   poison_batches(_stream(xs, ys), range(4, 20)), 20,
                   guard=True, ckpt_dir=tmp_path, ckpt_every=4,
                   max_rollbacks=1)

    def test_guard_requires_chunked_driver(self):
        model, params = _model(name="tg-one")
        xs, ys = synth_digits(64, seed=0)
        with pytest.raises(ValueError):
            train_classifier(model, params, _stream(xs, ys), steps=2,
                             guard=True, steps_per_call=1)

    def test_guarded_clean_run_matches_unguarded(self):
        model, params = _model(name="tg-clean", codesign="qat")
        xs, ys = synth_digits(256, seed=0)
        res = _train(model, params, _stream(xs, ys), 8, guard=True)
        ref = _train(model, params, _stream(xs, ys), 8)
        assert res.skipped_steps == 0
        _equal_trees(res.params, ref.params)


# ==========================================================================
# Physics faults on frozen planes (the reference's TestPerturbFrozen)
# ==========================================================================
class TestPerturbFrozen:
    def test_zero_faults_is_identity(self):
        model, params = _model(name="pf-id", codesign="qat")
        dep = freeze(model, params, device=CPU)
        same = perturb_frozen(dep)
        assert same.frozen[0] is dep.frozen[0]
        assert same.frozen[1] is dep.frozen[1]

    @pytest.mark.parametrize("kw", [
        dict(phase_sigma=0.5), dict(dead_frac=0.3), dict(shift_px=2),
    ])
    def test_faults_change_outputs_not_the_original(self, kw):
        model, params = _model(name="pf-ch", codesign="qat")
        dep = freeze(model, params, device=CPU)
        x = _digits(2)
        ref = InferenceEngine(dep, buckets=(2,), device=CPU).infer(x)
        pert = perturb_frozen(dep, seed=3, **kw)
        got = InferenceEngine(pert, buckets=(2,), device=CPU).infer(x)
        assert not np.array_equal(got, ref)
        np.testing.assert_array_equal(
            InferenceEngine(dep, buckets=(2,), device=CPU).infer(x), ref)

    def test_pallas_polar_convention(self):
        model, params = _model(name="pf-pl", depth=2, codesign="qat",
                               use_pallas=True)
        dep = freeze(model, params, device=CPU)
        pert = perturb_frozen(dep, phase_sigma=0.4, seed=5)
        assert torch.equal(pert.frozen[1], dep.frozen[1])
        assert not torch.equal(pert.frozen[0], dep.frozen[0])

    def test_cartesian_preserves_amplitude(self):
        model, params = _model(name="pf-amp", codesign="qat")
        dep = freeze(model, params, device=CPU)
        pert = perturb_frozen(dep, phase_sigma=0.4, seed=5)
        amp0 = torch.hypot(dep.frozen[0], dep.frozen[1]).numpy()
        amp1 = torch.hypot(pert.frozen[0], pert.frozen[1]).numpy()
        np.testing.assert_allclose(amp1, amp0, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("use_pallas,dtype", [
        (False, "float32"), (True, "float32"), (False, "bfloat16"),
        (True, "bfloat16"),
    ])
    @pytest.mark.parametrize("kw", [
        dict(phase_sigma=0.3), dict(dead_frac=0.2),
        dict(phase_sigma=0.1, dead_frac=0.1, shift_px=3),
    ])
    def test_bitwise_equal_to_reference(self, tmp_path, use_pallas, dtype,
                                        kw):
        """Same planes (through a JAX-written artifact), same seed: the
        reference's perturbed planes bit for bit, outputs within RTOL."""
        _, _, jm, jp = _pair("cls", use_pallas)
        jdep = jinf.freeze(jm, jp, plane_dtype=dtype)
        jres.save_deployed(jdep, tmp_path)
        dep = load_deployed(tmp_path, device=CPU)
        want = jperturb(jdep, seed=11, **kw)
        got = perturb_frozen(dep, seed=11, **kw)
        for g, w in zip(got.frozen, want.frozen):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        x = _digits(4, seed=6)
        _hold_outputs(
            InferenceEngine(got, buckets=(4,), device=CPU).infer(x),
            np.asarray(want.forward(jnp.asarray(x))), "cls")


# ==========================================================================
# Checkpoint discovery under damage (the reference's TestLatestStepFallback)
# ==========================================================================
class TestLatestStepFallback:
    def test_dangling_pointer_falls_back_to_newest_valid(self, tmp_path):
        s = {"w": np.arange(4, dtype=np.float32)}
        ckpt.save(tmp_path, 1, s)
        ckpt.save(tmp_path, 2, s)
        (tmp_path / "step_00000002" / "MANIFEST.json").write_text("not json")
        assert ckpt.latest_step(tmp_path) == 1
        assert ckpt.valid_steps(tmp_path) == [1]

    def test_missing_pointer_scans_directories(self, tmp_path):
        s = {"w": np.arange(4, dtype=np.float32)}
        ckpt.save(tmp_path, 3, s)
        ckpt.save(tmp_path, 5, s)
        (tmp_path / "LATEST").unlink()
        assert ckpt.latest_step(tmp_path) == 5

    def test_empty_dir_is_none(self, tmp_path):
        assert ckpt.latest_step(tmp_path) is None
        assert ckpt.valid_steps(tmp_path / "missing") == []


# ==========================================================================
# serve_donn: --save-artifact, --artifact, --replicas
# ==========================================================================
SERVE = ["--n", "32", "--depth", "2", "--use-pallas", "--device", "cpu",
         "--buckets", "1,4,8"]


def test_serve_donn_saves_then_cold_starts_an_artifact(tmp_path, capsys):
    art = tmp_path / "art"
    assert serve_donn.main(SERVE + ["--requests", "8", "--save-artifact",
                                    str(art)]) > 0
    assert validate_artifact(art)["spec"]["use_pallas"] is True
    assert serve_donn.main(["--artifact", str(art), "--device", "cpu",
                            "--buckets", "1,4,8", "--requests", "16"]) > 0
    out = capsys.readouterr().out
    assert "cold-started from" in out and "16/16 requests served" in out


def test_serve_donn_refuses_a_bad_artifact_before_any_warmup(
        tmp_path, monkeypatch, capsys):
    art = tmp_path / "art"
    model, params = _model(name="cli-bad", depth=2)
    save_deployed(freeze(model, params, device=CPU), art)
    meta = json.loads((art / ARTIFACT_FILE).read_text())
    meta["format"] = 99
    (art / ARTIFACT_FILE).write_text(json.dumps(meta))
    touched = []
    monkeypatch.setattr(serve_donn, "load_deployed",
                        lambda *a, **k: touched.append("load"))
    monkeypatch.setattr(InferenceEngine, "warmup",
                        lambda *a, **k: touched.append("warmup"))
    for bad in (art, tmp_path / "missing"):
        with pytest.raises(SystemExit) as e:
            serve_donn.main(["--artifact", str(bad), "--device", "cpu"])
        assert e.value.code == 2
    assert touched == []
    assert "failed pre-deploy validation" in capsys.readouterr().err


def test_serve_donn_replicas_serve_every_request(tmp_path, capsys):
    assert serve_donn.main(SERVE + ["--requests", "48",
                                    "--replicas", "2"]) > 0
    out = capsys.readouterr().out
    assert "continuous-batching fleet: 2 replica(s)" in out
    assert "48/48 requests served" in out and "shed 0, expired 0" in out
    assert "replicas=2, clean_close=True" in out
