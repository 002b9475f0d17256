"""The port's DSL, DSE and helpers against the JAX package (CPU).

- ``core/dse.py``: the numpy GBDT and ``LightRidgeDSE`` are a copy, so
  the port's predictions, choices and scores equal the reference's to
  the bit on the same points; ``explore``/``sensitivity_analysis``
  verified through the port's ``emulate_batch`` pick what the sequential
  ``emulate`` picks, and what the reference picks through its own.
- ``core/dsl.py``: the spec JSON is shared — a spec the JAX package
  writes builds the same port model (forward within 1e-5 of the
  reference's), and the port's ``to_spec`` writes the reference's spec.
- ``core/baselines.py``, ``regularization.recalibrated`` and the
  fabrication exports (``to_slm``, ``to_3d_render``) against the
  reference's.
- The two example flows at CPU size: the quickstart (DSL -> train ->
  export -> serve) and the four steps of the codesign flow.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import build_model as jbuild  # noqa: E402
from repro.core import codesign as jcd  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import dsl as jdsl  # noqa: E402
from repro.core import emulate_batch as jemulate  # noqa: E402
from repro.core import models as jmod  # noqa: E402
from repro.core import regularization as jreg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import codesign as tcd  # noqa: E402
from repro_torch.core import dse as tdse  # noqa: E402
from repro_torch.core import dsl as tdsl  # noqa: E402
from repro_torch.core import models as tmod  # noqa: E402
from repro_torch.core import propagation as tpp  # noqa: E402
from repro_torch.core import regularization as treg  # noqa: E402
from repro_torch.core import train_utils as ttu  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.diffraction import Grid  # noqa: E402
from repro_torch.core.laser import Laser  # noqa: E402
from repro_torch.core.models import build_model, emulate_batch  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.runtime.inference import InferenceEngine, freeze  # noqa: E402

RTOL = 1e-5
CPU = "cpu"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _jax_cfg(tcfg: DONNConfig):
    d = dataclasses.asdict(tcfg)
    if tcfg.layers is not None:
        d["layers"] = tuple(jconfig.LayerSpec(**l) for l in d["layers"])
    return jconfig.DONNConfig(**d)


def _params(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), CPU)


# ------------------------------------------------------------ GBDT
@pytest.mark.parametrize("kw", [
    dict(n_estimators=300, learning_rate=0.1, max_depth=3),
    dict(n_estimators=60, learning_rate=0.2, max_depth=2, subsample=0.7),
])
def test_gbdt_fits_and_predicts_like_reference(kw):
    r = np.random.default_rng(0)
    X = r.uniform(-2, 2, size=(200, 2))
    y = np.sin(X[:, 0]) * X[:, 1] ** 2 + 0.05 * r.normal(size=200)
    got = tdse.GradientBoostingRegressor(**kw).fit(X[:150], y[:150])
    want = jdse.GradientBoostingRegressor(**kw).fit(X[:150], y[:150])
    assert np.array_equal(got.predict(X), want.predict(X))
    if "subsample" not in kw:  # tests/test_dse.py::test_fits_nonlinear
        assert np.sqrt(np.mean((got.predict(X[:150]) - y[:150]) ** 2)) < 0.1


def test_gbdt_paper_hyperparameters_run():
    """The paper's config (3500 trees, lr .2, depth 3) fits (test_dse.py)."""
    r = np.random.default_rng(25)
    X = r.uniform(0, 1, size=(121, 3))
    y = np.cos(3 * X[:, 0]) + X[:, 1] * X[:, 2]
    m = tdse.GradientBoostingRegressor(n_estimators=3500, learning_rate=0.2,
                                       max_depth=3, random_state=25).fit(X, y)
    assert np.sqrt(np.mean((m.predict(X) - y) ** 2)) < 0.05


# ------------------------------------------------------------ DSE
def _landscape(lam, d, D):
    """tests/test_dse.py's synthetic accuracy landscape (paper Fig. 5)."""
    a = np.exp(-((d / lam - 68) ** 2) / 400.0)
    b = np.exp(-((d * d / (lam * D) - 0.008) ** 2) / 2e-5)
    return float(np.clip(0.1 + 0.9 * a * b, 0, 1))


def _grid(lam):
    pts, accs = [], []
    for d in np.linspace(10 * lam, 110 * lam, 11):
        for D in np.linspace(0.1, 0.6, 11):
            pts.append((lam, d, D))
            accs.append(_landscape(lam, d, D))
    return pts, accs


def _fitted(mod, n_estimators=300):
    pts, accs = [], []
    for lam in (432e-9, 632e-9):
        p, a = _grid(lam)
        pts += p
        accs += a
    return mod.LightRidgeDSE(n_estimators=n_estimators).fit(pts, accs)


def test_dse_transfer_matches_reference():
    """Train on 432+632 nm grids, explore 532 nm (paper Fig. 5 flow)."""
    lam = 532e-9
    cand = [(d, D) for d in np.linspace(10 * lam, 110 * lam, 11)
            for D in np.linspace(0.1, 0.6, 11)]
    got = _fitted(tdse).explore(lam, cand, emulate=lambda p: _landscape(*p),
                                top_k=2)
    want = _fitted(jdse).explore(lam, cand, emulate=lambda p: _landscape(*p),
                                 top_k=2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.speedup >= 50
    assert got.verified_acc >= max(_landscape(lam, d, D)
                                   for d, D in cand) - 0.05


def test_dse_batched_explore_equals_sequential():
    dse = _fitted(tdse)
    lam = 532e-9
    cand = [(d, D) for d in np.linspace(10 * lam, 110 * lam, 11)
            for D in np.linspace(0.1, 0.6, 11)]
    calls = []

    def batch(points):
        calls.append(list(points))
        return [_landscape(*p) for p in points]

    res_b = dse.explore(lam, cand, emulate_batch=batch, top_k=3)
    res_s = dse.explore(lam, cand, emulate=lambda p: _landscape(*p), top_k=3)
    assert len(calls) == 1 and len(calls[0]) == 3
    assert res_b == res_s


def test_dse_refusals():
    dse = _fitted(tdse, n_estimators=50)
    with pytest.raises(ValueError):
        dse.predict([(10e-6, 36e-6, 0.3)])  # IR: outside the neighbourhood
    with pytest.raises(ValueError):
        dse.explore(432e-9, [(36e-6, 0.3)])
    cand = [(36e-6, 0.3), (30e-6, 0.25), (40e-6, 0.35)]
    with pytest.raises(ValueError, match="scores"):
        dse.explore(432e-9, cand, emulate_batch=lambda pts: [0.5], top_k=2)
    with pytest.raises(ValueError, match="3- and 4-tuple"):
        tdse.LightRidgeDSE(n_estimators=10).fit(
            [(500e-9, 20e-6, 0.05), (500e-9, 20e-6, 0.05, 2)], [0.5, 0.6])


def test_sensitivity_analysis_batched_equals_sequential_and_reference():
    best = (532e-9, 36e-6, 0.3)
    calls = []

    def batch(points):
        calls.append(list(points))
        return [_landscape(*p) for p in points]

    out_b = tdse.sensitivity_analysis(None, best, emulate_batch=batch)
    out_s = tdse.sensitivity_analysis(lambda p: _landscape(*p), best)
    assert len(calls) == 1 and len(calls[0]) == 15  # 3 params x 5 deltas
    assert out_b == out_s == jdse.sensitivity_analysis(
        lambda p: _landscape(*p), best)
    rows = {k: dict(v) for k, v in out_s.items()}
    drop = {k: r[0.0] - min(r[-0.05], r[0.05]) for k, r in rows.items()}
    assert drop["unit_size"] >= drop["distance"] - 1e-9
    with pytest.raises(ValueError):
        tdse.sensitivity_analysis(None, best)


def test_rank_layouts_matches_reference():
    recs = [
        {"name": "a", "terms": {"compute_s": 1.0, "memory_s": 5.0,
                                "collective_s": 2.0}},
        {"name": "b", "terms": {"compute_s": 1.0, "memory_s": 2.0,
                                "collective_s": 1.5}},
        {"name": "c", "terms": {"compute_s": 3.0, "memory_s": 3.0,
                                "collective_s": 0.1}},
    ]
    got = [r["name"] for r in tdse.rank_layouts(recs)]
    assert got == [r["name"] for r in jdse.rank_layouts(recs)] == [
        "b", "c", "a"]


# DSE verification through emulation: the port's emulate_batch scores the
# DSE's candidates in one pass; the scores are a continuous figure of merit
# in [0, 1], where the DSE expects an accuracy (1 - half the MSE-softmax
# loss of random-parameter logits), so a pick is decided by the
# emulation, not by a tie
_DSE_BASE = dict(n=32, depth=2, det_size=6)


def _cfg(point):
    lam, d, D = point[:3]
    depth = int(point[3]) if len(point) > 3 else _DSE_BASE["depth"]
    return DONNConfig(name="dse", wavelength=float(lam), pixel_size=float(d),
                      distance=float(D), **{**_DSE_BASE, "depth": depth})


def _scorers():
    xs, ys = tsyn.synth_digits(8, seed=0)
    y = torch.from_numpy(ys)
    params = build_model(_cfg((532e-9, 36e-6, 0.05)), device=CPU).init(
        torch.Generator().manual_seed(0))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)

    def score(logits):
        return 1.0 - 0.5 * float(ttu.mse_softmax_loss(
            torch.from_numpy(np.array(logits, np.float32)), y, 10))

    def emulate(point):
        c = _cfg(point)
        return score(build_model(c, device=CPU).apply(params,
                                                      torch.from_numpy(xs)))

    def batch(points):
        out = emulate_batch([_cfg(p) for p in points], params, xs, device=CPU)
        return [score(o) for o in out]

    def jbatch(points):
        out = jemulate([_jax_cfg(_cfg(p)) for p in points], jparams,
                       jnp.asarray(xs))
        return [score(o) for o in out]

    return emulate, batch, jbatch


def _dse_grid():
    pts, accs = [], []
    for lam in (432e-9, 632e-9):
        for d in (24e-6, 36e-6, 48e-6):
            for D in (0.03, 0.05, 0.08):
                pts.append((lam, d, D))
                accs.append(_landscape(lam, d * 2, D * 6))
    return tdse.LightRidgeDSE(n_estimators=100).fit(pts, accs)


def test_explore_through_emulate_batch_picks_the_sequential_point():
    emulate, batch, jbatch = _scorers()
    dse = _dse_grid()
    cand = [(d, D) for d in (24e-6, 36e-6, 48e-6) for D in (0.03, 0.05, 0.08)]
    res_b = dse.explore(532e-9, cand, emulate_batch=batch, top_k=4)
    res_s = dse.explore(532e-9, cand, emulate=emulate, top_k=4)
    res_j = dse.explore(532e-9, cand, emulate_batch=jbatch, top_k=4)
    assert res_b.best_point == res_s.best_point == res_j.best_point
    assert abs(res_b.verified_acc - res_s.verified_acc) <= RTOL * abs(
        res_s.verified_acc)
    assert abs(res_b.verified_acc - res_j.verified_acc) <= RTOL * abs(
        res_j.verified_acc)


def test_sensitivity_through_emulate_batch_equals_sequential():
    emulate, batch, jbatch = _scorers()
    best = (532e-9, 36e-6, 0.05)
    got = tdse.sensitivity_analysis(None, best, emulate_batch=batch)
    seq = tdse.sensitivity_analysis(emulate, best)
    ref = tdse.sensitivity_analysis(None, best, emulate_batch=jbatch)
    for name in got:
        g = np.array([s for _, s in got[name]])
        assert _rel(g, [s for _, s in seq[name]]) <= RTOL
        assert _rel(g, [s for _, s in ref[name]]) <= RTOL


def test_explore_with_depth_candidates_through_emulate_batch():
    """``TestMixedDepthEmulateBatch::test_dse_explore_with_depth_candidates``
    with the port's mixed-depth emulate_batch as the verifier."""
    rng = np.random.default_rng(0)
    pts, accs = [], []
    for lam in (500e-9, 600e-9):
        for d in (20e-6, 36e-6):
            for D in (0.05, 0.1):
                for depth in (2, 4):
                    pts.append((lam, d, D, depth))
                    accs.append(0.5 + 0.05 * depth + rng.uniform(0, 0.01))
    dse = tdse.LightRidgeDSE(n_estimators=40).fit(pts, accs)
    xs, _ = tsyn.synth_digits(4, seed=0)
    seen = {}

    def batch(points):
        seen["pts"] = points
        cfgs = [_cfg(p) for p in points]
        plist = [build_model(c, device=CPU).init(
            torch.Generator().manual_seed(i)) for i, c in enumerate(cfgs)]
        out = emulate_batch(cfgs, plist, xs, device=CPU)
        return [float(o.mean()) for o in out]

    res = dse.explore(550e-9, [(20e-6, 0.05, 2), (36e-6, 0.1, 4),
                               (20e-6, 0.1, 4)], top_k=2, emulate_batch=batch)
    assert len(seen["pts"]) == 2 and len(seen["pts"][0]) == 4
    assert "depth" in res.best_point


# ------------------------------------------------------------ DSL
_BASE = dict(n=48, depth=3, distance=0.05, det_size=6)
MIXED = (
    LayerSpec(distance=0.04, size=48, device_levels=256, codesign="qat"),
    LayerSpec(distance=0.05, size=48, device_levels=256, codesign="qat"),
    LayerSpec(distance=0.05, size=32, pixel_size=54e-6, device_levels=4,
              codesign="qat"),
)
SPEC_CFGS = {
    "uniform_qat": DONNConfig(name="u", **_BASE, codesign="qat",
                              device_levels=64),
    "heterogeneous": DONNConfig(name="h", **{**_BASE, "layers": MIXED}),
    "segmentation": DONNConfig(name="s", **{**_BASE, "segmentation": True,
                                            "skip_from": 0,
                                            "layer_norm": True}),
    "runtime_knobs": DONNConfig(name="d", **_BASE, scan_unroll=2,
                                tf_dtype="bfloat16", engine="eager",
                                channels=3, num_classes=6, remat="layer"),
    "uniform_off_detector_grid": DONNConfig(
        name="og", **{**_BASE, "layers": (LayerSpec(distance=0.05,
                                                    size=32),) * 3}),
}


def _spec_input(cfg):
    if cfg.channels > 1:
        return tsyn.synth_rgb_scenes(2, seed=0, size=28)[0]
    if cfg.segmentation:
        return tsyn.synth_seg(2, seed=0, size=48)[0]
    return tsyn.synth_digits(2, seed=0)[0]


@pytest.mark.parametrize("name", list(SPEC_CFGS))
def test_spec_round_trip_between_the_packages(name):
    cfg = SPEC_CFGS[name]
    jcfg = _jax_cfg(cfg)
    spec = jdsl.to_spec(jcfg)
    assert tdsl.to_spec(cfg) == spec  # the port writes the reference's spec
    text = json.dumps(spec)
    model, cfg2 = tdsl.from_spec(json.loads(text), device=CPU)
    jmodel, jcfg2 = jdsl.from_spec(json.loads(text))
    assert cfg2.resolved_layers() == cfg.resolved_layers()
    assert tmod.config_static_key(cfg2) == tmod.config_static_key(cfg)
    assert tpp.plan_cache_key(cfg2, 1.0) == tpp.plan_cache_key(cfg, 1.0)
    jp = jmodel.init(jax.random.PRNGKey(0))
    x = _spec_input(cfg)
    want = jmodel.apply(jp, jnp.asarray(x))
    got = model.apply(_params(jp), torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= RTOL


def test_spec_round_trip_keeps_the_laser_and_detector_grid():
    cfg = DONNConfig(name="dg", n=64, depth=2, distance=0.05, det_size=8,
                     layers=(LayerSpec(distance=0.05, size=48),
                             LayerSpec(distance=0.05, size=32,
                                       pixel_size=54e-6)))
    lz = tdsl.laser(wavelength=532e-9, profile="gaussian", waist=1e-3,
                    power=2.0)
    spec = tdsl.to_spec(cfg, lz)
    assert spec == jdsl.to_spec(_jax_cfg(cfg), jdsl.laser(
        wavelength=532e-9, profile="gaussian", waist=1e-3, power=2.0))
    model, cfg2 = tdsl.from_spec(json.loads(json.dumps(spec)), device=CPU)
    assert (cfg2.n, cfg2.pixel_size) == (cfg.n, cfg.pixel_size)
    assert model.laser == Laser(wavelength=532e-9, profile="gaussian",
                                waist=1e-3, power=2.0)
    ref = build_model(cfg, lz, device=CPU)
    p = ref.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(tsyn.synth_digits(2, seed=5)[0])
    assert torch.equal(model.apply(p, x), ref.apply(p, x))


def test_sequential_builds_the_reference_config():
    def stack(lr_):
        src = lr_.laser(wavelength=532e-9)
        front = [lr_.layers.diffractlayer(distance=0.05, size=48,
                                          precision=256) for _ in range(2)]
        back = [lr_.layers.diffractlayer(distance=0.05, size=32,
                                         pixel_size=48e-6, precision=4)]
        raw = lr_.layers.diffractlayer_raw(distance=0.05, size=48)
        det = lr_.layers.detector(num_classes=10, det_size=6, distance=0.05)
        return src, front + back, [raw] * 3, det

    src, hetero, raw, det = stack(tdsl)
    jsrc, jhetero, jraw, jdet = stack(jdsl)
    assert (hetero, raw, det) == (jhetero, jraw, jdet)
    for layers, jlayers in ((hetero, jhetero), (raw, jraw)):
        model, cfg = tdsl.models.sequential(layers, det, laser=src,
                                            name="dsl", device=CPU)
        _, jcfg = jdsl.models.sequential(jlayers, jdet, laser=jsrc,
                                         name="dsl")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert model.device == torch.device(CPU)
    assert tdsl.spec_to_config(tdsl.to_spec(cfg)) == cfg
    assert isinstance(tdsl.from_config(cfg, device=CPU), tmod.DONN)


# ------------------------------------------------------------ helpers
def test_lightpipes_like_baseline_matches_reference():
    r = np.random.default_rng(0)
    x = r.random((2, 16, 16))
    phases = [r.uniform(0, 2 * np.pi, (16, 16)) for _ in range(2)]
    dists = (0.05, 0.04, 0.06)
    got = tbase.LightPipesLikeEngine(Grid(16, 36e-6), 532e-9).donn_forward(
        x, phases, dists)
    from repro.core.diffraction import Grid as JGrid

    want = jbase.LightPipesLikeEngine(JGrid(16, 36e-6), 532e-9).donn_forward(
        x, phases, dists)
    assert np.array_equal(got, want)


def test_fabrication_exports_match_reference():
    r = np.random.default_rng(1)
    phi = r.uniform(-9, 9, (20, 20)).astype(np.float32)
    for levels in (4, 256, 1024):
        dev, jdev = tcd.DeviceSpec(levels=levels), jcd.DeviceSpec(
            levels=levels)
        got = tcd.to_slm(torch.from_numpy(phi), dev)
        want = jcd.to_slm(jnp.asarray(phi), jdev)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = tcd.to_3d_render(torch.from_numpy(phi), 532e-9)
    want = jcd.to_3d_render(jnp.asarray(phi), 532e-9)
    assert got.dtype == np.float32 and _rel(got, want) <= 1e-6


def test_recalibrated_matches_reference():
    cfg = DONNConfig(name="rc", n=32, depth=3, distance=0.05, det_size=6)
    jm = jbuild(_jax_cfg(cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    x = tsyn.synth_digits(8, seed=0)[0]
    model, g = treg.recalibrated(tmod.DONN, cfg, _params(jp), x, device=CPU)
    jmodel, jg = jreg.recalibrated(jmod.DONN, _jax_cfg(cfg), jp,
                                   jnp.asarray(x))
    assert abs(g - jg) <= RTOL * jg and model.cfg.gamma == g
    u = torch.randn(2, 8, 8, dtype=torch.complex64)
    assert torch.allclose(treg.energy(treg.apply_gamma(u, 2.0)),
                          4.0 * treg.energy(u))


# ------------------------------------------------------------ the flows
def test_quickstart_flow_at_cpu_size():
    """``examples/quickstart.py`` on the port: DSL -> calibrated gamma ->
    chunked training -> evaluation -> SLM export -> frozen serving."""
    src = tdsl.laser(wavelength=532e-9, profile="plane")
    layers = [tdsl.layers.diffractlayer_raw(distance=0.05, pixel_size=36e-6,
                                            size=64) for _ in range(3)]
    det = tdsl.layers.detector(num_classes=10, det_size=8, distance=0.05)
    model, cfg = tdsl.models.sequential(layers, det, laser=src,
                                        name="quickstart", device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    xs, ys = tsyn.synth_digits(1024, seed=0)
    g = treg.calibrate_gamma(model, params, xs[:16])
    model = tdsl.from_config(dataclasses.replace(cfg, gamma=g), device=CPU)
    res = ttu.train_classifier(model, params,
                               tsyn.batch_iterator(xs, ys, 64, seed=1),
                               steps=60, lr=0.5, steps_per_call=10)
    assert np.mean(res.losses[-10:]) < 0.6 * np.mean(res.losses[:10])
    acc = ttu.evaluate_classifier(model, res.params,
                                  tsyn.batch_iterator(xs, ys, 128, seed=2), 4)
    assert acc > 0.5
    for phi in res.params["phase"].values():
        img = tcd.to_slm(phi, tcd.DeviceSpec(levels=256))
        assert img.shape == (64, 64) and img.dtype == np.uint8
    engine = InferenceEngine(freeze(model, res.params, device=CPU),
                             buckets=(1, 8, 32), device=CPU)
    preds = engine.infer(xs[:32]).argmax(-1)
    want = model.apply(res.params, torch.from_numpy(xs[:32])).argmax(-1)
    assert np.array_equal(preds, want.numpy())


def test_codesign_flow_four_steps_at_cpu_size():
    """``examples/donn_codesign_flow.py``: DSE (verified through
    emulate_batch) -> QAT training on the chosen point -> fabrication
    export -> hard-quantized deployment."""
    xs, ys = tsyn.synth_digits(512, seed=0)
    emulate, batch, _ = _scorers()
    dse = _dse_grid()
    cand = [(d, D) for d in (24e-6, 36e-6, 48e-6) for D in (0.03, 0.05)]
    res = dse.explore(532e-9, cand, emulate_batch=batch, top_k=3)
    best = res.best_point
    assert res.emulations_used == 3 and res.grid_size == 6
    cfg = DONNConfig(name="codesign", n=32, pixel_size=best["unit_size"],
                     wavelength=532e-9, distance=best["distance"], depth=2,
                     det_size=6, codesign="qat", device_levels=256)
    model = build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(1))
    g = treg.calibrate_gamma(model, params, xs[:16])
    model = build_model(dataclasses.replace(cfg, gamma=g), device=CPU)
    res_t = ttu.train_classifier(model, params,
                                 tsyn.batch_iterator(xs, ys, 32, seed=3),
                                 steps=20, lr=0.5, steps_per_call=10)
    assert all(np.isfinite(res_t.losses))
    for phi in res_t.params["phase"].values():
        assert tcd.to_slm(phi, tcd.DeviceSpec(levels=256)).dtype == np.uint8
        thick = tcd.to_3d_render(phi, cfg.wavelength)
        assert 0 <= thick.min() and thick.max() <= 532e-9 / 0.52
    dep = build_model(dataclasses.replace(model.cfg, codesign="ptq"),
                      device=CPU)
    x = torch.from_numpy(xs[:64])
    # QAT trains on the phases PTQ fabricates: the deployed logits are the
    # trained model's own (the two round phi to a level by different
    # formulas, which agree to f32 rounding)
    assert _rel(dep.apply(res_t.params, x).numpy(),
                model.apply(res_t.params, x).numpy()) <= RTOL
