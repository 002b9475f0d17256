"""The port's advanced DONNs against the JAX package (CPU): the RGB
multi-channel classifier, segmentation with the optical skip, and
heterogeneous (segmented-plan) stacks.

Both packages build the same ``DONNConfig``; parameters come from the JAX
``model.init`` and are carried over with ``params_from_jax``; inputs are
the synthetic sets, byte-equal on both sides, or seeded numpy arrays.
With ``use_pallas`` the JAX side runs its Pallas kernels in interpret mode
and the port runs its kernels' plain PyTorch versions (CPU tensors).

Tolerances (max|port - jax| / max|jax|, f32): 1e-5, the reference's own
engine tolerance, on outputs and on every layer's d/dphase.  Frozen
serving equals the port's own ``apply`` at eval bit for bit.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import build_model as jbuild  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import diffraction as jdf  # noqa: E402
from repro.core import dsl as jdsl  # noqa: E402
from repro.core import propagation as jpp  # noqa: E402
from repro.core import train_utils as jtu  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import inference as jinf  # noqa: E402
from repro_torch.configs.donn import HYBRID_SLM_PRINTED  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import diffraction as tdf  # noqa: E402
from repro_torch.core import propagation as tpp  # noqa: E402
from repro_torch.core import train_utils as ttu  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.models import (  # noqa: E402
    DONN, MultiChannelDONN, SegmentationDONN, build_model,
)
from repro_torch.core.regularization import calibrate_gamma  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)

RTOL = 1e-5
CPU = "cpu"
ENGINES = ("scan", "eager")

# the reference's heterogeneous stacks (tests/test_hetero.py): two
# precisions and two plane sizes on a 48-px system grid
MIXED = (
    LayerSpec(distance=0.04, size=48, device_levels=256, codesign="qat"),
    LayerSpec(distance=0.05, size=48, device_levels=256, codesign="qat"),
    LayerSpec(distance=0.05, size=32, pixel_size=54e-6, device_levels=4,
              codesign="qat"),
)
HETERO = {
    "mixed_size_precision": MIXED,
    "mixed_method": (LayerSpec(distance=0.04, approximation="rs"),
                     LayerSpec(distance=0.05, approximation="fresnel"),
                     LayerSpec(distance=0.05, approximation="rs")),
    "mixed_pitch": (LayerSpec(distance=0.04),
                    LayerSpec(distance=0.05, pixel_size=54e-6),
                    LayerSpec(distance=0.05, pixel_size=54e-6)),
}
HETERO_BASE = dict(n=48, depth=3, distance=0.05, det_size=6)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    kind = np.complex128 if np.iscomplexobj(want) else np.float64
    got, want = got.astype(kind), want.astype(kind)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _jax_cfg(tcfg: DONNConfig):
    d = dataclasses.asdict(tcfg)
    if tcfg.layers is not None:
        d["layers"] = tuple(jconfig.LayerSpec(**l) for l in d["layers"])
    return jconfig.DONNConfig(**d)


def _pair(seed=0, **kw):
    """(port model, port params, jax model, jax params) for one config."""
    kw.setdefault("name", "fam")
    kw.setdefault("n", 32)
    kw.setdefault("depth", 2)
    kw.setdefault("distance", 0.05)
    kw.setdefault("det_size", 6)
    tcfg = DONNConfig(**kw)
    jm = jbuild(_jax_cfg(tcfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device=CPU)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return tm, tp, jm, jp


def _port_grads(model, params, loss_fn):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params["phase"].items()}
    with torch.enable_grad():
        loss = loss_fn(model, {"phase": leaves})
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def _hold_grads(got, want):
    (loss, grads), (wloss, wgrads) = got, want
    assert abs(loss - float(wloss)) <= RTOL * abs(float(wloss))
    assert set(grads) == set(wgrads["phase"])
    for k, g in grads.items():
        assert _rel(g.numpy(), wgrads["phase"][k]) <= RTOL, k


def _rgb(b=4, seed=0, size=32):
    return tsyn.synth_rgb_scenes(b, seed=seed, size=size)[0]


def _seg(b=4, seed=0, size=32):
    return tsyn.synth_seg(b, seed=seed, size=size)


def _digits(b=4, seed=0):
    return tsyn.synth_digits(b, seed=seed)[0]


# ------------------------------------------------------------ data
@pytest.mark.parametrize("name,kw", [
    ("synth_rgb_scenes", dict(size=48)), ("synth_rgb_scenes", {}),
    ("synth_seg", dict(size=40)), ("synth_seg", {}),
])
def test_synthetic_sets_are_byte_equal_to_reference(name, kw):
    got = getattr(tsyn, name)(9, seed=3, **kw)
    want = getattr(jsyn, name)(9, seed=3, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ------------------------------------------------------------ containers
def test_build_model_dispatches_by_family():
    base = dict(name="d", n=32, depth=2, distance=0.05, det_size=6)
    assert type(build_model(DONNConfig(**base), device=CPU)) is DONN
    assert isinstance(build_model(DONNConfig(**base, channels=3),
                                  device=CPU), MultiChannelDONN)
    seg = build_model(DONNConfig(**base, segmentation=True, skip_from=0),
                      device=CPU)
    assert isinstance(seg, SegmentationDONN) and seg.skip_hop is not None
    assert not seg.skip_hop.use_pallas  # cuFFT and a multiply, as JAX's
    with pytest.raises(ValueError, match="MultiChannelDONN"):
        DONN(DONNConfig(**base, channels=3), device=CPU)


def test_params_from_jax_carries_rgb_and_ragged_phases():
    tm, tp, jm, jp = _pair(channels=3, num_classes=6)
    assert tm.param_shapes()["phase"]["layer_0"] == (3, 32, 32)
    for k, v in jp["phase"].items():
        assert tuple(tp["phase"][k].shape) == (3, 32, 32)
        np.testing.assert_array_equal(tp["phase"][k].numpy(), np.asarray(v))
    tm, tp, jm, jp = _pair(**HETERO_BASE, layers=MIXED)
    shapes = [tuple(tp["phase"][f"layer_{i}"].shape) for i in range(3)]
    assert shapes == [(48, 48), (48, 48), (32, 32)]
    assert tm.param_shapes()["phase"]["layer_2"] == (32, 32)
    own = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(own["phase"][f"layer_{i}"].shape) for i in range(3)] \
        == shapes
    phis = tm.stacked_phases(tp)
    assert isinstance(phis, tuple) and len(phis) == 2
    assert phis[0].shape == (2, 48, 48) and phis[1].shape == (1, 32, 32)


# ------------------------------------------------------------ RGB
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_rgb_apply_matches_reference(engine, use_pallas):
    tm, tp, jm, jp = _pair(channels=3, num_classes=6, engine=engine,
                           use_pallas=use_pallas)
    x = _rgb()
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == (4, 6)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_rgb_gradients_match_reference(engine, use_pallas):
    tm, tp, jm, jp = _pair(seed=2, channels=3, num_classes=6, engine=engine,
                           use_pallas=use_pallas, codesign="qat")
    x = _rgb(seed=1)
    want = jax.value_and_grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2))(jp)
    got = _port_grads(tm, tp, lambda m, p: torch.sum(
        m.apply(p, torch.from_numpy(x)) ** 2))
    _hold_grads(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rgb_scan_matches_eager_in_the_port(use_pallas):
    """TestMultiChannelBatched: the batched plan against the per-channel
    loop, outputs and gradients."""
    tm, tp, _, _ = _pair(channels=3, num_classes=6, use_pallas=use_pallas)
    te = build_model(dataclasses.replace(tm.cfg, engine="eager"), device=CPU)
    x = torch.from_numpy(_rgb(seed=2))
    assert _rel(tm.apply(tp, x).numpy(), te.apply(tp, x).numpy()) <= RTOL
    loss = lambda m, p: torch.sum(m.apply(p, x) ** 2)  # noqa: E731
    _, gs = _port_grads(tm, tp, loss)
    _, ge = _port_grads(te, tp, loss)
    for k in gs:
        assert _rel(gs[k].numpy(), ge[k].numpy()) <= 1e-4, k


def test_channel_readout_matches_reference_kernel():
    r = np.random.default_rng(0)
    u = (r.normal(size=(2, 3, 24, 24))
         + 1j * r.normal(size=(2, 3, 24, 24))).astype(np.complex64)
    masks = r.random((6, 24, 24)).astype(np.float32)
    want = np.asarray(jops.channel_intensity_readout(
        jnp.asarray(u.real), jnp.asarray(u.imag), jnp.asarray(masks)))
    got = tops.channel_intensity_readout(torch.from_numpy(u),
                                         torch.from_numpy(masks))
    assert got.shape == (2, 6)
    assert _rel(got.numpy(), want) <= RTOL


# ------------------------------------------------------------ segmentation
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_segmentation_apply_matches_reference(engine, use_pallas, train):
    """The optical skip on both engines; the layer norm only in training."""
    tm, tp, jm, jp = _pair(segmentation=True, skip_from=0, layer_norm=True,
                           codesign="qat", engine=engine,
                           use_pallas=use_pallas)
    x, _ = _seg()
    want = np.asarray(jm.apply(jp, jnp.asarray(x), train=train))
    got = tm.apply(tp, torch.from_numpy(x), train=train).numpy()
    assert got.shape == (4, 32, 32)
    assert _rel(got, want) <= RTOL
    if train:  # normalized per image: zero mean, unit variance
        np.testing.assert_allclose(got.mean(axis=(-2, -1)), 0.0, atol=1e-4)
    else:
        assert got.min() >= 0.0  # a raw intensity map


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_segmentation_gradients_match_reference(engine, use_pallas):
    tm, tp, jm, jp = _pair(seed=1, segmentation=True, skip_from=1,
                           layer_norm=True, depth=3, engine=engine,
                           use_pallas=use_pallas)
    x, m = _seg(seed=2)
    want = jax.value_and_grad(lambda p: jtu.bce_segmentation_loss(
        jm.apply(p, jnp.asarray(x), train=True), jnp.asarray(m)))(jp)
    got = _port_grads(tm, tp, lambda mdl, p: ttu.bce_segmentation_loss(
        mdl.apply(p, torch.from_numpy(x), train=True), torch.from_numpy(m)))
    _hold_grads(got, want)


def test_segmentation_scan_matches_eager_in_the_port():
    """TestScanMatchesEager::test_segmentation_with_skip, in the port."""
    tm, tp, _, _ = _pair(segmentation=True, skip_from=0, layer_norm=True,
                         depth=3)
    te = build_model(dataclasses.replace(tm.cfg, engine="eager"), device=CPU)
    x = torch.from_numpy(_seg()[0])
    assert _rel(tm.apply(tp, x, train=True).numpy(),
                te.apply(tp, x, train=True).numpy()) <= RTOL


def test_segmentation_without_skip_matches_reference():
    tm, tp, jm, jp = _pair(segmentation=True, skip_from=None)
    assert tm.skip_hop is None
    x, _ = _seg(seed=3)
    want = np.asarray(jm.apply(jp, jnp.asarray(x), train=True))
    assert _rel(tm.apply(tp, torch.from_numpy(x), train=True).numpy(),
                want) <= RTOL


def test_bce_and_iou_match_reference():
    r = np.random.default_rng(0)
    inten = r.normal(size=(3, 16, 16)).astype(np.float32) * 3.0
    mask = (r.random((3, 16, 16)) > 0.6).astype(np.float32)
    t, m = torch.from_numpy(inten), torch.from_numpy(mask)
    assert _rel(float(ttu.bce_segmentation_loss(t, m)),
                float(jtu.bce_segmentation_loss(inten, mask))) <= 1e-6
    for thresh in (0.0, 1.5):
        assert float(ttu.iou(t, m, thresh)) == pytest.approx(
            float(jtu.iou(inten, mask, thresh)), rel=1e-6)
    empty = torch.zeros((1, 4, 4))
    assert float(ttu.iou(empty, empty)) == 0.0  # union clamped to 1


# ------------------------------------------------------------ heterogeneous
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("layers", list(HETERO), ids=list(HETERO))
def test_heterogeneous_classify_matches_reference(layers, engine,
                                                  use_pallas):
    tm, tp, jm, jp = _pair(**HETERO_BASE, layers=HETERO[layers],
                           engine=engine, use_pallas=use_pallas)
    assert isinstance(tm.plan, tpp.SegmentedPlan)
    assert tm.plan.segment_slices == jm.plan.segment_slices
    x = _digits()
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    assert _rel(tm.apply(tp, torch.from_numpy(x)).numpy(), want) <= RTOL


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_heterogeneous_gradients_match_reference(engine, use_pallas):
    tm, tp, jm, jp = _pair(seed=1, **HETERO_BASE, layers=MIXED,
                           engine=engine, use_pallas=use_pallas)
    x = _digits(seed=1)
    want = jax.value_and_grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2))(jp)
    got = _port_grads(tm, tp, lambda m, p: torch.sum(
        m.apply(p, torch.from_numpy(x)) ** 2))
    _hold_grads(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_heterogeneous_rgb_and_segmentation_match_reference(engine):
    """MultiChannelDONN and SegmentationDONN over a segmented plan
    (tests/test_hetero.py:209,220, on the 48-px mix)."""
    base = dict(HETERO_BASE, layers=MIXED, engine=engine, use_pallas=True)
    tm, tp, jm, jp = _pair(**base, channels=3, num_classes=6)
    x = _rgb()
    assert _rel(tm.apply(tp, torch.from_numpy(x)).numpy(),
                np.asarray(jm.apply(jp, jnp.asarray(x)))) <= RTOL
    tm, tp, jm, jp = _pair(**base, segmentation=True, skip_from=0,
                           layer_norm=True)
    x, _ = _seg()
    got = tm.apply(tp, torch.from_numpy(x), train=True).numpy()
    assert got.shape == (4, 48, 48)  # the detector/system grid
    assert _rel(got, np.asarray(jm.apply(jp, jnp.asarray(x),
                                         train=True))) <= RTOL


def _segmented_inputs(seed=0):
    cfg = DONNConfig(name="sl", **HETERO_BASE, layers=MIXED)
    r = np.random.default_rng(seed)
    phases = [r.uniform(0, 2 * np.pi, (s.size, s.size)).astype(np.float32)
              for s in cfg.resolved_layers()]
    u = (r.normal(size=(2, 48, 48))
         + 1j * r.normal(size=(2, 48, 48))).astype(np.complex64)
    tplan = tpp.plan_from_config(cfg, 1.0)
    jplan = jpp.plan_from_config(_jax_cfg(cfg), 1.0)
    return (tplan, tplan.stack_phases(torch.from_numpy(p) for p in phases),
            torch.from_numpy(u), jplan,
            jplan.stack_phases(jnp.asarray(p) for p in phases), jnp.asarray(u))


@pytest.mark.parametrize("cut", [1, 2])  # mid-segment and boundary
def test_segmented_slices_compose_to_full_forward(cut):
    plan, phis, u, jplan, jphis, ju = _segmented_inputs()
    full = plan.forward(phis, u)
    tail = plan.forward(phis, plan.forward(phis, u, stop=cut), start=cut)
    assert _rel(tail.numpy(), full.numpy()) <= RTOL
    assert _rel(full.numpy(), np.asarray(jplan.forward(jphis, ju))) <= RTOL


def test_segmented_apply_lands_on_the_detector_grid():
    plan, phis, u, jplan, jphis, ju = _segmented_inputs(seed=1)
    out = plan.apply(phis, u)
    assert out.shape == (2, 48, 48)
    assert _rel(out.numpy(), np.asarray(jplan.apply(jphis, ju))) <= RTOL
    with pytest.raises(ValueError, match="inner segment"):
        plan.segments[0].propagate_final(u)


def test_hybrid_config_is_the_dsl_stack_of_the_example():
    """HYBRID_SLM_PRINTED equals the config the reference's DSL assembles
    for examples/advanced_donns.py's hybrid stack."""
    front = [jdsl.layers.diffractlayer(distance=0.10, pixel_size=36e-6,
                                       size=64, precision=256)
             for _ in range(3)]
    back = [jdsl.layers.diffractlayer(distance=0.05, pixel_size=48e-6,
                                      size=48, precision=4)
            for _ in range(2)]
    det = jdsl.layers.detector(num_classes=10, det_size=8, distance=0.06)
    want = jdsl._sequential_config(front + back, det,
                                   laser=jdsl.laser(wavelength=532e-9),
                                   name="hybrid-slm-printed")
    assert dataclasses.asdict(_jax_cfg(HYBRID_SLM_PRINTED)) \
        == dataclasses.asdict(want)
    assert tpp.plan_from_config(HYBRID_SLM_PRINTED, 1.0).segment_slices \
        == ((0, 3), (3, 5))


# ------------------------------------------------------------ resampling
def test_resample_matrix_and_field_match_reference():
    r = np.random.default_rng(0)
    pairs = [(tdf.Grid(48, 36e-6), tdf.Grid(32, 54e-6)),
             (tdf.Grid(64, 36e-6), tdf.Grid(48, 48e-6)),
             (tdf.Grid(32, 36e-6), tdf.Grid(48, 36e-6)),
             (tdf.Grid(48, 36e-6), tdf.Grid(32, 36e-6)),
             (tdf.Grid(33, 36e-6), tdf.Grid(48, 36e-6))]
    for g_in, g_out in pairs:
        jg_in = jdf.Grid(g_in.n, g_in.pixel_size)
        jg_out = jdf.Grid(g_out.n, g_out.pixel_size)
        np.testing.assert_array_equal(tdf.resample_matrix(g_in, g_out),
                                      jdf.resample_matrix(jg_in, jg_out))
        u = (r.normal(size=(2, g_in.n, g_in.n))
             + 1j * r.normal(size=(2, g_in.n, g_in.n))).astype(np.complex64)
        got = tdf.resample_field(torch.from_numpy(u), g_in, g_out)
        want = np.asarray(jdf.resample_field(jnp.asarray(u), jg_in, jg_out))
        assert got.shape == (2, g_out.n, g_out.n)
        assert _rel(got.numpy(), want) <= 1e-6


def test_resampling_identity_crop_pad_and_unity():
    g = tdf.Grid(32, 36e-6)
    u = torch.ones((32, 32), dtype=torch.complex64)
    assert tdf.resample_field(u, g, g) is u
    g_in, g_out = tdf.Grid(32, 36e-6), tdf.Grid(48, 36e-6)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 32))
                         .astype(np.float32))
    back = tdf.resample_field(tdf.resample_field(x, g_in, g_out), g_out, g_in)
    assert torch.equal(back, x)  # pad then crop, exactly
    assert set(np.unique(tdf.resample_matrix(g_in, g_out))) <= {0.0, 1.0}
    sums = tdf.resample_matrix(tdf.Grid(48, 36e-6),
                               tdf.Grid(32, 54e-6)).sum(axis=1)
    np.testing.assert_allclose(sums[2:-2], 1.0, atol=1e-6)


def test_resample_matrix_cache_is_bounded_lru(monkeypatch):
    monkeypatch.setattr(tdf, "_RESAMPLE_CACHE", {})
    monkeypatch.setattr(tdf, "_RESAMPLE_CACHE_MAX", 3)
    grids = [tdf.Grid(8 + i, 36e-6) for i in range(5)]
    out = tdf.Grid(16, 36e-6)
    for g in grids[:3]:
        tdf.resample_matrix(g, out)
    a = tdf.resample_matrix(grids[0], out)  # hit: refresh recency
    tdf.resample_matrix(grids[3], out)  # evicts grids[1], the oldest
    assert len(tdf._RESAMPLE_CACHE) <= 3
    assert tdf.resample_matrix(grids[0], out) is a


# ------------------------------------------------------------ serving
FAMILY_KW = {
    "multi": dict(name="fz-rgb", channels=3, num_classes=6, codesign="qat"),
    "seg": dict(name="fz-seg", segmentation=True, skip_from=0,
                layer_norm=True, codesign="qat"),
    "hetero": dict(name="fz-het", n=40, det_size=4, depth=3,
                   layers=(LayerSpec(0.05, size=40), LayerSpec(0.05, size=40),
                           LayerSpec(0.05, codesign="qat",
                                     device_levels=4))),
    # the skip leaves from the 32-px plane: its hop is stitched onto the
    # 48-px detector grid, as the main path's final hop is
    "hetero-seg": dict(name="fz-hseg", n=48, depth=3, layers=MIXED,
                       segmentation=True, skip_from=2, layer_norm=True),
}


def _family_input(family, b, seed):
    if family == "multi":
        return np.random.default_rng(seed).random((b, 3, 28, 28), np.float32)
    return _digits(b, seed=seed)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("family", list(FAMILY_KW))
def test_frozen_serving_is_bit_identical_to_apply(family, use_pallas):
    """TestFrozenBitIdentity: the engine (3 requests padded to bucket 4)
    gives the model's eval forward bit for bit."""
    kw = {"n": 32, "depth": 2, "det_size": 6, "gamma": 1.1,
          **FAMILY_KW[family]}
    model = build_model(DONNConfig(distance=0.05, use_pallas=use_pallas,
                                   **kw), device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    x = _family_input(family, 3, seed=1)
    want = model.apply(params, torch.from_numpy(x)).numpy()
    dep = freeze(model, params, device=CPU)
    assert dep.family == ("multi" if family == "multi" else
                          "seg" if "seg" in family else "cls")
    got = InferenceEngine(dep, buckets=(4,), device=CPU).infer(x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family,dtype", [
    ("multi", "float32"), ("multi", "bfloat16"), ("multi", "int8"),
    ("seg", "float32"), ("seg", "bfloat16"), ("seg", "int8"),
    ("hetero", "float32"), ("hetero", "int8"), ("hetero-seg", "float32"),
])
def test_deployed_families_match_reference(family, dtype):
    tm, tp, jm, jp = _pair(**{"depth": 2, **FAMILY_KW[family]},
                           use_pallas=True)
    x = _family_input(family, 4, seed=2)
    jdep = jinf.freeze(jm, jp, plane_dtype=dtype)
    want = np.asarray(jax.jit(jdep.forward)(jnp.asarray(x)))
    dep = freeze(tm, tp, plane_dtype=dtype, device=CPU)
    assert dep.plane_dtype == dtype == jdep.plane_dtype
    got = InferenceEngine(dep, buckets=(4,), device=CPU).infer(x)
    assert _rel(got, want) <= RTOL
    if dep.family != "seg":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("family", ["multi", "seg"])
def test_rfft_first_serves_rgb_and_segmentation_like_reference(family):
    tm, tp, jm, jp = _pair(**FAMILY_KW[family], use_pallas=True)
    x = _family_input(family, 2, seed=4)
    want = np.asarray(jinf.freeze(jm, jp, rfft_first=True).forward(
        jnp.asarray(x)))
    got = freeze(tm, tp, rfft_first=True, device=CPU).forward(
        torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= RTOL


def test_segmented_plan_refuses_rfft_first():
    tm, tp, _, _ = _pair(**FAMILY_KW["hetero"])
    with pytest.raises(ValueError, match="rfft_first covers uniform"):
        freeze(tm, tp, rfft_first=True, device=CPU)


def test_micro_batcher_serves_rgb_requests():
    model = build_model(DONNConfig(name="mb-rgb", n=32, depth=2,
                                   distance=0.05, det_size=6, channels=3,
                                   num_classes=6, use_pallas=True),
                        device=CPU)
    params = model.init(torch.Generator().manual_seed(1))
    eng = InferenceEngine(freeze(model, params, device=CPU), buckets=(2, 4),
                          device=CPU)
    assert eng.warmup().keys() == {2, 4}
    x = _family_input("multi", 5, seed=6)
    want = eng.infer(x)
    assert eng.infer(x[0]).shape == (1, 6)  # one request, no batch axis
    mb = MicroBatcher(eng, max_wait_ms=5.0)
    got = np.stack([f.result(timeout=60) for f in [mb.submit(r) for r in x]])
    with pytest.raises(ValueError, match="per-request shape"):
        mb.submit(np.zeros((28, 28), np.float32))
    assert mb.close(timeout=30)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("family,out", [("rgb", "8/8 requests served"),
                                        ("segmentation",
                                         "8/8 requests served")])
def test_serve_cli_serves_rgb_and_segmentation(family, out, capsys):
    rps = serve_donn.main(["--family", family, "--n", "32", "--depth", "2",
                           "--det-size", "6", "--requests", "8",
                           "--buckets", "1,4", "--use-pallas",
                           "--train-steps", "4", "--device", "cpu"])
    assert rps > 0
    text = capsys.readouterr().out
    assert out in text and "trained" not in text  # --train-steps: classify


def test_gamma_plane_is_built_once_per_shape():
    plan = tpp.plan_from_config(DONNConfig(name="g", n=32, depth=2,
                                           distance=0.05, det_size=6,
                                           gamma=1.3, use_pallas=True), 1.3)
    a = plan._gamma_plane((3, 32, 32), torch.device("cpu"))
    assert plan._gamma_plane((3, 32, 32), torch.device("cpu")) is a
    assert a.dtype == torch.float32 and torch.all(a == 1.3)
    assert plan._gamma_plane((32, 32), torch.device("cpu")).shape == (32, 32)


# ------------------------------------------------------------ training
def test_rgb_loss_halves_in_thirty_steps():
    """TestAdvancedArchitectures::test_multichannel_rgb_forward_and_train."""
    cfg = DONNConfig(name="rgb", n=64, depth=2, distance=0.05, det_size=8,
                     channels=3, num_classes=6)
    model = build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    xs, ys = tsyn.synth_rgb_scenes(96, seed=0)
    g = calibrate_gamma(model, params, xs[:8])
    model = build_model(dataclasses.replace(cfg, gamma=g), device=CPU)
    res = ttu.train_classifier(model, params,
                               tsyn.batch_iterator(xs, ys, 16, seed=1),
                               steps=30, lr=0.3, num_classes=6,
                               steps_per_call=10)
    assert res.losses[-1] < 0.5 * res.losses[0]


def test_segmentation_loss_falls():
    """TestAdvancedArchitectures::test_segmentation_trains: 25 AdamW steps
    of BCE on the layer-normed intensity, the step written by hand."""
    cfg = DONNConfig(name="seg", n=64, depth=2, distance=0.05,
                     segmentation=True, skip_from=0, layer_norm=True)
    model = build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    xs, ms = tsyn.synth_seg(64, seed=1)
    opt = AdamW(lr=0.05)
    state = opt.init(params)
    losses = []
    for i in range(25):
        s = (i * 16) % 48
        loss, grads = _port_grads(model, params, lambda m, p: (
            ttu.bce_segmentation_loss(
                m.apply(p, torch.from_numpy(xs[s:s + 16]), train=True),
                torch.from_numpy(ms[s:s + 16]))))
        params, state = opt.update({"phase": grads}, state, params, i)
        losses.append(loss)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
