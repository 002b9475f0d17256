"""The port's frozen serving slice against the JAX package (CPU).

Both packages build the same ``DONNConfig``; parameters come from the JAX
``model.init`` and are carried over with ``params_from_jax``; inputs come
from seeded numpy generators.  With ``use_pallas`` the JAX side runs its
Pallas kernels in interpret mode and the port runs its kernels' plain
PyTorch versions (CPU tensors).

Tolerances (max|port - jax| / max|jax|, f32): 1e-5, the reference's own
engine tolerance.  Measured with the CPU builds of torch 2.13 and jax 0.9:
logits agree to <= 3.2e-7 on every case here (the two sides use different
FFT and matmul builds).  bf16 and int8 frozen planes are held to the
reference's measured bounds against f32 (1.8e-3 / 4.7e-3, its plane-dtype
cell) with argmax parity.
"""
import dataclasses
import threading
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import build_model as jbuild  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.runtime import inference as jinf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.models import DONN, build_model  # noqa: E402
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)
from repro_torch.runtime.resilience import (  # noqa: E402
    DeadlineExceededError, OverloadedError,
)

RTOL = 1e-5
CPU = "cpu"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _digits(b, seed=0):
    return np.random.default_rng(seed).random((b, 28, 28), np.float32)


def _pair(seed=0, **kw):
    """(port model, port params, jax model, jax params) for one config."""
    kw.setdefault("n", 32)
    kw.setdefault("depth", 3)
    kw.setdefault("distance", 0.05)
    kw.setdefault("det_size", 6)
    tcfg = DONNConfig(**kw)
    jcfg = jconfig.DONNConfig(**dataclasses.asdict(tcfg))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device=CPU)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return tm, tp, jm, jp


@pytest.fixture(scope="module")
def qat_pair():
    return {p: _pair(name="sv-qat", codesign="qat", response_gamma=1.2,
                     gamma=1.12, use_pallas=p) for p in (False, True)}


# ------------------------------------------------------------ parameters
def test_params_from_jax_layout_and_values(qat_pair):
    tm, tp, jm, jp = qat_pair[True]
    assert set(tp) == {"phase"}
    assert set(tp["phase"]) == {f"layer_{i}" for i in range(3)}
    for k, v in jp["phase"].items():
        assert tp["phase"][k].dtype == torch.float32
        np.testing.assert_array_equal(tp["phase"][k].numpy(), np.asarray(v))
    with pytest.raises(ValueError, match="phase"):
        params_from_jax({"w": np.zeros(2, np.float32)}, CPU)


def test_init_is_seeded_and_in_range():
    model = build_model(DONNConfig(name="init", n=32, depth=2,
                                   distance=0.05, det_size=6), device=CPU)
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    for k, v in a["phase"].items():
        assert v.shape == (32, 32) and v.dtype == torch.float32
        assert float(v.min()) >= 0.0 and float(v.max()) < 2 * np.pi
        assert torch.equal(v, b["phase"][k])


# ------------------------------------------------------------ slice parity
@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_matches_reference(qat_pair, use_pallas):
    tm, tp, jm, jp = qat_pair[use_pallas]
    x = _digits(3)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frozen_planes_match_reference(qat_pair, use_pallas, dtype):
    tm, tp, jm, jp = qat_pair[use_pallas]
    got = freeze(tm, tp, plane_dtype=dtype, device=CPU).frozen
    want = jinf.freeze(jm, jp, plane_dtype=dtype).frozen
    assert len(got) == len(want) == (4 if dtype == "int8" else 2)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        if dtype == "float32":
            # polar planes are the codesign phase itself (bit-equal);
            # cartesian ones are gamma*cos/sin from two libms
            assert _rel(g, w) <= (0.0 if use_pallas else 1e-6)
        elif dtype == "bfloat16":
            # within one bf16 rounding step of each other
            assert np.all(np.abs(g - w) <= 2.0 ** -8 * np.abs(w) + 1e-30)
        else:
            # int8 codes within one quantization step; scales f32-close
            assert np.max(np.abs(g - w)) <= (1.0 if g.ndim == 3 else
                                             1e-6 * np.max(np.abs(w)))


@pytest.mark.parametrize("use_pallas,dtype,rfft", [
    (False, "float32", False), (False, "float32", True),
    (True, "float32", False), (True, "float32", True),
    (False, "bfloat16", False), (True, "bfloat16", False),
    (False, "int8", False), (True, "int8", True),
])
def test_deployed_forward_matches_reference(qat_pair, use_pallas, dtype,
                                            rfft):
    tm, tp, jm, jp = qat_pair[use_pallas]
    x = _digits(4, seed=1)
    jdep = jinf.freeze(jm, jp, plane_dtype=dtype, rfft_first=rfft)
    want = np.asarray(jax.jit(jdep.forward)(jnp.asarray(x)))
    dep = freeze(tm, tp, plane_dtype=dtype, rfft_first=rfft, device=CPU)
    assert dep.plane_dtype == dtype and dep.rfft_first == rfft
    got = dep.forward(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= RTOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_smoke_config_slice_matches_reference():
    """donn-mnist-5l-smoke (n=64, depth 5, qat, gamma 1.12) end to end."""
    tcfg = dataclasses.replace(get_config("donn-mnist-5l", smoke=True),
                               use_pallas=True)
    jm = jbuild(jconfig.DONNConfig(**dataclasses.asdict(tcfg)))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg, device=CPU)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    x = _digits(4, seed=2)
    jeng = jinf.InferenceEngine(jinf.freeze(jm, jp), buckets=(4,))
    want = jeng.infer(x)
    eng = InferenceEngine(freeze(tm, tp, device=CPU), buckets=(4,),
                          device=CPU)
    got = eng.infer(x)
    assert _rel(got, want) <= RTOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kw", [
    dict(approximation="fresnel", distance=0.3),
    dict(approximation="fraunhofer", distance=0.5),
    dict(pad=True),
    dict(tf_dtype="bfloat16"),
    dict(band_limit=False, distance=0.02),
])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_plan_variants_match_reference(kw, use_pallas):
    """Fraunhofer and padded hops take the two-site path (K2 twice)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # regime warnings of the geometry
        tm, tp, jm, jp = _pair(name="sv-var", depth=2, codesign="qat",
                               use_pallas=use_pallas, **kw)
        x = _digits(2, seed=3)
        want = np.asarray(jm.apply(jp, jnp.asarray(x)))
        got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert tm.plan._fuse == (use_pallas and kw.get("approximation") !=
                             "fraunhofer" and not kw.get("pad", False))
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kw", [
    dict(), dict(codesign="qat"), dict(codesign="qat", response_gamma=1.2),
    dict(codesign="gumbel"), dict(codesign="gumbel_hard"),
    dict(codesign="ptq", device_levels=16),
])
def test_frozen_forward_bit_identical_to_apply(kw, use_pallas):
    """The port's serving path equals its own eval forward bit for bit."""
    model = build_model(DONNConfig(name="bit", n=32, depth=3, distance=0.05,
                                   det_size=6, gamma=1.1,
                                   use_pallas=use_pallas, **kw), device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_digits(3))
    want = model.apply(params, x)
    got = InferenceEngine(freeze(model, params, device=CPU), buckets=(4,),
                          device=CPU).infer(x.numpy())
    np.testing.assert_array_equal(got, want.numpy())


# ------------------------------------------------------------ plane dtypes
def test_quantized_planes_within_reference_bounds():
    """The reference's plane-dtype cell (n=64, depth 8, qat, response 1.2)."""
    tm, tp, jm, jp = _pair(name="pd-cls", n=64, depth=8, det_size=8,
                           codesign="qat", response_gamma=1.2)
    x = np.random.default_rng(4).random((32, 28, 28), np.float32)
    outs, jouts = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        outs[dtype] = InferenceEngine(
            freeze(tm, tp, plane_dtype=dtype, device=CPU), buckets=(32,),
            device=CPU).infer(x)
        jouts[dtype] = jinf.InferenceEngine(
            jinf.freeze(jm, jp, plane_dtype=dtype), buckets=(32,)).infer(x)
    for dtype, bound in (("bfloat16", 1.8e-3), ("int8", 4.7e-3)):
        delta = _rel(outs[dtype], outs["float32"])
        jdelta = _rel(jouts[dtype], jouts["float32"])
        assert delta <= bound, (dtype, delta)
        assert abs(delta - jdelta) <= 1e-4, (dtype, delta, jdelta)
        np.testing.assert_array_equal(outs[dtype].argmax(-1),
                                      outs["float32"].argmax(-1))
        assert _rel(outs[dtype], jouts[dtype]) <= RTOL


# ------------------------------------------------------------ engine
def test_engine_pads_and_chunks(qat_pair):
    tm, tp, jm, jp = qat_pair[True]
    dep = freeze(tm, tp, device=CPU)
    eng = InferenceEngine(dep, buckets=(2, 4), device=CPU)
    assert set(eng.warmup()) == {2, 4}
    x = _digits(7, seed=5)
    got = eng.infer(x)
    assert got.shape == (7, 10)
    assert eng.stats == {"requests": 7, "batches": 2, "padded_rows": 1}
    per_sample = np.concatenate([dep.forward(torch.from_numpy(x[i:i + 1]))
                                 .numpy() for i in range(7)])
    assert _rel(got, per_sample) <= RTOL
    want = jinf.InferenceEngine(jinf.freeze(jm, jp),
                                buckets=(2, 4)).infer(x)
    assert _rel(got, want) <= RTOL
    # a single image is a batch of one
    assert eng.infer(x[0]).shape == (1, 10)


def test_engine_validates_arguments(qat_pair):
    tm, tp, _, _ = qat_pair[False]
    dep = freeze(tm, tp, device=CPU)
    with pytest.raises(ValueError, match="positive"):
        InferenceEngine(dep, buckets=(0, 2), device=CPU)
    with pytest.raises(NotImplementedError, match="multi-device"):
        InferenceEngine(dep, mesh_devices=2, device=CPU)
    with pytest.raises(NotImplementedError, match="multi-device"):
        InferenceEngine(dep, model_devices=2, device=CPU)
    with pytest.raises(ValueError, match="plane_dtype"):
        freeze(tm, tp, plane_dtype="float16", device=CPU)
    with pytest.raises(TypeError, match="cannot freeze"):
        freeze(object(), tp, device=CPU)


def _blocked_engine(qat_pair):
    """An engine whose infer waits on an event (a stalled device call)."""
    tm, tp, _, _ = qat_pair[False]
    eng = InferenceEngine(freeze(tm, tp, device=CPU), buckets=(1, 2, 4),
                          device=CPU)
    gate = threading.Event()
    real = eng.infer

    def infer(x):
        assert gate.wait(timeout=30)
        return real(x)

    eng.infer = infer
    return eng, gate


def test_micro_batcher_matches_engine(qat_pair):
    tm, tp, _, _ = qat_pair[True]
    eng = InferenceEngine(freeze(tm, tp, device=CPU), buckets=(1, 2, 4),
                          device=CPU)
    x = _digits(6, seed=6)
    mb = MicroBatcher(eng, max_wait_ms=5.0)
    futs = [mb.submit(xi) for xi in x]
    got = np.stack([f.result(timeout=60) for f in futs])
    assert mb.close(timeout=30)
    assert mb.stats["served"] == 6 and mb.stats["failed"] == 0
    assert _rel(got, eng.infer(x)) <= RTOL


def test_micro_batcher_sheds_and_expires(qat_pair):
    eng, gate = _blocked_engine(qat_pair)
    mb = MicroBatcher(eng, max_wait_ms=1.0, max_queue=2)
    x = _digits(4, seed=7)
    first = mb.submit(x[0])  # taken by the worker, which then stalls
    deadline = threading.Event()
    for _ in range(200):
        if mb.stats["submitted"] == 1 and not mb._pending:
            break
        deadline.wait(0.01)
    late = mb.submit(x[1], timeout_ms=1.0)
    mb.submit(x[2])
    with pytest.raises(OverloadedError):
        mb.submit(x[3])
    assert mb.stats["shed"] == 1
    gate.set()
    assert first.result(timeout=60).shape == (10,)
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=60)
    assert mb.close(timeout=30)
    assert mb.stats["expired"] == 1


def test_micro_batcher_validates_and_bisects(qat_pair):
    tm, tp, _, _ = qat_pair[False]
    eng = InferenceEngine(freeze(tm, tp, device=CPU), buckets=(4,),
                          device=CPU)
    mb = MicroBatcher(eng, max_wait_ms=50.0)
    with pytest.raises(ValueError, match="shape"):
        mb.submit(np.zeros((27, 28), np.float32))
    with pytest.raises(TypeError, match="dtype"):
        mb.submit(np.zeros((28, 28), np.complex64))
    assert mb.close(timeout=30)
    # trust-the-caller mode: a poisoned request fails only its own future
    mb = MicroBatcher(eng, max_wait_ms=50.0, validate=False)
    good = [mb.submit(x) for x in _digits(3, seed=8)]
    # larger than the n=32 grid: fails to stack with the group and alone
    bad = mb.submit(np.zeros((40, 40), np.float32))
    assert all(f.result(timeout=60).shape == (10,) for f in good)
    with pytest.raises(ValueError, match="grid smaller"):
        bad.result(timeout=60)
    assert mb.close(timeout=30)
    assert mb.stats["failed"] == 1 and mb.stats["served"] == 3


# ------------------------------------------------------------ CLI + refusals
def test_serve_cli_on_cpu(capsys):
    rps = serve_donn.main(["--n", "32", "--depth", "2", "--det-size", "6",
                           "--requests", "12", "--buckets", "1,4,8",
                           "--use-pallas", "--device", "cpu"])
    assert rps > 0
    assert "12/12 requests served" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--family", "rgb"], "RGB"),
    (["--family", "segmentation"], "segmentation"),
    (["--train-steps", "4"], "training"),
    (["--artifact", "dir"], "persistence"),
    (["--save-artifact", "dir"], "persistence"),
    (["--mesh-devices", "2"], "multi-device"),
    (["--replicas", "2"], "fleet"),
])
def test_serve_cli_refuses_later_slices(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        serve_donn.main(flags + ["--n", "32", "--depth", "2",
                                 "--device", "cpu"])


@pytest.mark.parametrize("kw,match", [
    (dict(channels=3), "RGB"),
    (dict(segmentation=True, skip_from=0), "segmentation"),
    (dict(engine="eager"), "eager"),
    (dict(layers=(LayerSpec(0.05, size=40), LayerSpec(0.05))),
     "heterogeneous"),
])
def test_models_refuse_later_slices(kw, match):
    kw.setdefault("depth", 2)
    cfg = DONNConfig(name="later", n=32, distance=0.05, det_size=6, **kw)
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, device=CPU)


def test_rng_apply_refused(qat_pair):
    tm, tp, _, _ = qat_pair[False]
    with pytest.raises(NotImplementedError, match="training slice"):
        tm.apply(tp, torch.from_numpy(_digits(1)), rng=object())


def test_devices_must_agree(qat_pair):
    tm, tp, _, _ = qat_pair[False]
    assert isinstance(tm, DONN) and tm.device == torch.device("cpu")
    with pytest.raises(ValueError, match="lives on"):
        freeze(tm, tp, device="meta")
