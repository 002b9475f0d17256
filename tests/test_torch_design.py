"""The port's design flow against the JAX package (CPU): Gumbel codesign
with noise, batched multi-candidate emulation (``emulate_batch``,
``apply_batch``), ``remat`` and rng-driven training.

Both packages build the same ``DONNConfig``; parameters come from the JAX
``model.init`` (``params_from_jax``); inputs are the synthetic sets,
byte-equal on both sides.  With ``use_pallas`` the JAX side runs its
Pallas kernels in interpret mode and the port runs its kernels' plain
PyTorch versions (CPU tensors).

Noise: torch's Philox and JAX's threefry differ, so the port's one draw
function, ``repro_torch.core.codesign.gumbel_noise``, is replaced by
``_Replay``, which hands back the reference's own draws
(``jax.random.gumbel`` under the reference's key splits, through numpy)
in call order and checks each call's shape; a test then also checks that
every draw was used.  The call order is the port's documented contract:
global layer index 0..L-1, candidate by candidate in ``emulate_batch``,
step by step in training.

Tolerances (max|port - jax| / max|jax|, f32): 1e-5 on outputs, losses,
every layer's d/dphase and parameters, as the reference holds its own
engines.  Port-internal identities (remat against none, chunked against
per-step, batched against sequential) are held to 1e-6.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import build_model as jbuild  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import emulate_batch as jemulate  # noqa: E402
from repro.core import propagation as jpp  # noqa: E402
from repro.core import train_utils as jtu  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import codesign as tcd  # noqa: E402
from repro_torch.core import diffraction as tdf  # noqa: E402
from repro_torch.core import models as tmod  # noqa: E402
from repro_torch.core import propagation as tpp  # noqa: E402
from repro_torch.core import train_utils as ttu  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.laser import Laser  # noqa: E402
from repro_torch.core.models import (  # noqa: E402
    build_model, cached_apply, cached_model, emulate_batch,
)
from repro_torch.core.physics import (  # noqa: E402
    PhysicsValidationError, PhysicsWarning,
)
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

RTOL = 1e-5
SAME = 1e-6
CPU = "cpu"
GEOS = [(36e-6, 532e-9, 0.30), (30e-6, 432e-9, 0.25), (40e-6, 632e-9, 0.35)]


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


def _params(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _pair(seed=0, **kw):
    """(port model, port params, jax model, jax params) for one config."""
    for k, v in dict(name="des", n=32, depth=3, distance=0.05,
                     det_size=6).items():
        kw.setdefault(k, v)
    tcfg = DONNConfig(**kw)
    jm = jbuild(_jax_cfg(tcfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    return build_model(tcfg, device=CPU), _params(jp), jm, jp


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _digits(b=4, seed=0):
    return tsyn.synth_digits(b, seed=seed)[0]


# ------------------------------------------------------------ noise
class _Replay:
    """Stand-in for ``gumbel_noise``: the reference's draws in call order."""

    def __init__(self, draws):
        self.draws = [np.asarray(d, np.float32) for d in draws]
        self.calls = 0

    def __call__(self, generator, shape, dtype, device):
        assert isinstance(generator, torch.Generator)
        want = self.draws[self.calls]
        assert tuple(shape) == want.shape, (tuple(shape), want.shape)
        self.calls += 1
        return torch.from_numpy(want.copy()).to(device, dtype)

    def done(self):
        assert self.calls == len(self.draws), (self.calls, len(self.draws))


def _draws(key, shapes):
    """The reference's per-layer draws for one apply: layer i from
    ``split(key, L)[i]`` (``models.py:138-141``, ``propagation.py:747``)."""
    keys = jax.random.split(key, len(shapes))
    return [np.asarray(jax.random.gumbel(k, s, jnp.float32))
            for k, s in zip(keys, shapes)]


def _replay(monkeypatch, draws) -> _Replay:
    rp = _Replay(draws)
    monkeypatch.setattr(tcd, "gumbel_noise", rp)
    return rp


def _shapes(cfg, depth=None):
    return [(s.size, s.size, s.device_levels)
            for s in cfg.resolved_layers()][:depth]


def test_gumbel_noise_is_standard_gumbel_from_the_generator():
    a = tcd.gumbel_noise(_gen(3), (200, 300), torch.float32, CPU)
    b = tcd.gumbel_noise(_gen(3), (200, 300), torch.float32, CPU)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    # standard Gumbel: mean = Euler's constant, variance = pi^2 / 6
    assert abs(float(a.mean()) - 0.5772) < 0.01
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.03
    # the reference's formula at the uniform draw's edges stays finite
    assert torch.isfinite(-torch.log(-torch.log(torch.tensor(
        [torch.finfo(torch.float32).tiny, 1 - 2 ** -24])))).all()


@pytest.mark.parametrize("mode", ["gumbel", "gumbel_hard"])
def test_quantize_gumbel_with_noise_matches_reference(mode, monkeypatch):
    from repro.core import codesign as jcd

    r = np.random.default_rng(0)
    phi = r.uniform(-7, 7, (2, 12, 12)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    # the reference's channels share a layer's key under vmap (one
    # (n, n, levels) draw), as the port broadcasts its one draw
    want = jax.vmap(lambda p: jcd.apply_codesign(
        p, jcd.DeviceSpec(levels=8), mode, key, tau=0.7))(jnp.asarray(phi))
    g = np.asarray(jax.random.gumbel(key, (12, 12, 8), jnp.float32))
    rp = _replay(monkeypatch, [g])
    got = tcd.apply_codesign(torch.from_numpy(phi), tcd.DeviceSpec(levels=8),
                             mode, _gen(), tau=0.7)
    rp.done()
    assert _rel(got.numpy(), want) <= RTOL


# ------------------------------------------------------------ models
GUMBEL = [dict(codesign="gumbel", device_levels=16),
          dict(codesign="gumbel_hard", device_levels=8, use_pallas=True)]


@pytest.mark.parametrize("engine", ["scan", "eager"])
@pytest.mark.parametrize("kw", GUMBEL, ids=["gumbel", "gumbel_hard_pallas"])
def test_gumbel_apply_and_phase_gradients_match_reference(engine, kw,
                                                          monkeypatch):
    tm, tp, jm, jp = _pair(engine=engine, **kw)
    x = _digits(seed=2)
    key = jax.random.PRNGKey(7)
    draws = _draws(key, _shapes(tm.cfg))

    def jloss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), key) ** 2)

    want, wgrads = jax.value_and_grad(jloss)(jp)
    rp = _replay(monkeypatch, draws)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tp["phase"].items()}
    loss = torch.sum(tm.apply({"phase": leaves}, torch.from_numpy(x),
                              _gen()) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    rp.done()
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= RTOL * abs(float(want))
    for k, g in zip(leaves, grads):
        assert _rel(g.numpy(), wgrads["phase"][k]) <= RTOL, k


def test_engines_consume_one_generator_identically():
    """Same seed, real Philox draws: the eager and scan engines agree."""
    kw = dict(codesign="gumbel", device_levels=16, depth=3)
    tm, tp, _, _ = _pair(**kw)
    te = build_model(dataclasses.replace(tm.cfg, engine="eager"), device=CPU)
    x = torch.from_numpy(_digits(seed=3))
    a, b = tm.apply(tp, x, _gen(11)), te.apply(tp, x, _gen(11))
    assert _rel(a.numpy(), b.numpy()) <= SAME
    assert _rel(tm.apply(tp, x, _gen(12)).numpy(), a.numpy()) > 1e-3


@pytest.mark.parametrize("engine", ["scan", "eager"])
def test_rgb_channels_share_each_layers_draw(engine, monkeypatch):
    tm, tp, jm, jp = _pair(n=32, channels=3, num_classes=6, engine=engine,
                           codesign="gumbel", device_levels=8)
    x = tsyn.synth_rgb_scenes(4, seed=0, size=32)[0]
    key = jax.random.PRNGKey(3)
    want = jm.apply(jp, jnp.asarray(x), key)
    rp = _replay(monkeypatch, _draws(key, [(32, 32, 8)] * 3))
    got = tm.apply(tp, torch.from_numpy(x), _gen())
    rp.done()  # one draw a layer, not one a channel and layer
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("engine", ["scan", "eager"])
def test_segmentation_skip_draws_once_per_apply(engine, monkeypatch):
    tm, tp, jm, jp = _pair(n=32, segmentation=True, skip_from=0,
                           layer_norm=True, engine=engine,
                           codesign="gumbel", device_levels=8)
    x = tsyn.synth_seg(4, seed=0, size=32)[0]
    key = jax.random.PRNGKey(4)
    want = jm.apply(jp, jnp.asarray(x), key, train=True)
    # the reference resolves its whole stack in both forwards of the skip
    # split from one key stack; the port resolves it once
    rp = _replay(monkeypatch, _draws(key, [(32, 32, 8)] * 3))
    got = tm.apply(tp, torch.from_numpy(x), _gen(), train=True)
    rp.done()
    assert _rel(got.numpy(), want) <= RTOL


HETERO_RNG = (
    LayerSpec(distance=0.04, device_levels=16, codesign="gumbel"),
    LayerSpec(distance=0.05, size=32, pixel_size=54e-6, device_levels=8,
              codesign="gumbel"),
    LayerSpec(distance=0.05, size=32, pixel_size=54e-6, device_levels=8,
              codesign="gumbel"),
)


@pytest.mark.parametrize("engine", ["scan", "eager"])
def test_rng_codesign_alignment_on_a_segmented_plan(engine, monkeypatch):
    """``tests/test_hetero.py::TestHeterogeneousForward::
    test_rng_codesign_alignment``: layer i draws from key i on both
    engines, across the segment boundary."""
    tm, tp, jm, jp = _pair(n=48, depth=3, distance=0.05, det_size=6,
                           layers=HETERO_RNG, engine=engine)
    assert isinstance(tm.plan, tpp.SegmentedPlan) or engine == "eager"
    x = _digits(seed=2)
    key = jax.random.PRNGKey(7)
    want = jm.apply(jp, jnp.asarray(x), key)
    rp = _replay(monkeypatch, _draws(key, _shapes(tm.cfg)))
    got = tm.apply(tp, torch.from_numpy(x), _gen())
    rp.done()
    assert _rel(got.numpy(), want) <= RTOL


def _plan_inputs(seed=0, **kw):
    cfg = DONNConfig(**{**dict(name="t", n=32, depth=3, distance=0.05,
                               det_size=6), **kw})
    plan = tpp.plan_from_config(cfg, 1.0)
    jplan = jpp.plan_from_config(_jax_cfg(cfg), 1.0)
    r = np.random.default_rng(seed)
    phis = r.uniform(0, 2 * np.pi, (cfg.depth, cfg.n, cfg.n)).astype(
        np.float32)
    u = (r.normal(size=(2, cfg.n, cfg.n))
         + 1j * r.normal(size=(2, cfg.n, cfg.n))).astype(np.complex64)
    return cfg, plan, jplan, phis, u


@pytest.mark.parametrize("cut", [1, 2])
def test_slices_compose_with_codesign_rngs(cut, monkeypatch):
    """``tests/test_propagation_plan.py:112``: a slice boundary does not
    move any layer's noise."""
    cfg, plan, jplan, phis, u = _plan_inputs(seed=1, codesign="gumbel",
                                             device_levels=16)
    key = jax.random.PRNGKey(3)
    rngs = jax.random.split(key, cfg.depth)
    want = jplan.forward(jnp.asarray(phis), jnp.asarray(u), rngs)
    draws = [np.asarray(jax.random.gumbel(k, (32, 32, 16), jnp.float32))
             for k in rngs]
    rp = _replay(monkeypatch, draws * 2)
    tphis, tu = torch.from_numpy(phis), torch.from_numpy(u)
    head = plan.forward(tphis, tu, _gen(), stop=cut)
    tail = plan.forward(tphis, head, _gen(), start=cut)
    rp.done()
    assert _rel(tail.numpy(), want) <= RTOL
    eff = plan.codesign_stack(tphis)  # resolved once, run in two slices
    full = plan.forward(eff, tu, resolved=True)
    two = plan.forward(eff, plan.forward(eff, tu, stop=cut, resolved=True),
                       start=cut, resolved=True)
    assert _rel(two.numpy(), full.numpy()) <= SAME


def test_external_tfs_match_baked_constants():
    _, plan, _, phis, u = _plan_inputs(seed=2)
    tphis, tu = torch.from_numpy(phis), torch.from_numpy(u)
    got = plan.apply(tphis, tu, tfs=plan._tf_pair(tu.device))
    assert torch.equal(got, plan.apply(tphis, tu))


def test_masked_layers_pass_the_carry_with_zero_gradient():
    cfg, plan, jplan, phis, u = _plan_inputs(seed=3)
    mask = np.array([True, False, True])
    want = jplan.apply(jnp.asarray(phis), jnp.asarray(u),
                       mask=jnp.asarray(mask))
    tphis = torch.from_numpy(phis).requires_grad_(True)
    got = plan.apply(tphis, torch.from_numpy(u),
                     mask=torch.from_numpy(mask))
    assert _rel(got.detach().numpy(), want) <= RTOL
    (g,) = torch.autograd.grad(got.abs().square().sum(), tphis)
    assert torch.all(g[1] == 0) and torch.any(g[0] != 0)


# ------------------------------------------------------------ apply_batch
@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_batch_matches_stacked_sequential(use_pallas):
    cfg, plan, jplan, _, u = _plan_inputs(use_pallas=use_pallas)
    r = np.random.default_rng(0)
    phis = r.uniform(0, 2 * np.pi, (3, cfg.depth, cfg.n, cfg.n)).astype(
        np.float32)
    got = plan.apply_batch(torch.from_numpy(phis), torch.from_numpy(u))
    want = jplan.apply_batch(jnp.asarray(phis), jnp.asarray(u))
    assert _rel(got.numpy(), want) <= RTOL
    for k in range(3):
        seq = plan.apply(torch.from_numpy(phis[k]), torch.from_numpy(u))
        assert _rel(got[k].numpy(), seq.numpy()) <= SAME


def test_apply_batch_per_candidate_inputs_tfs_and_rng(monkeypatch):
    """``tests/test_propagation_plan.py:156``, with per-candidate planes."""
    cfg, plan, jplan, _, _ = _plan_inputs(codesign="gumbel", device_levels=8)
    r = np.random.default_rng(1)
    K = 2
    phis = r.uniform(0, 2 * np.pi, (K, cfg.depth, cfg.n, cfg.n)).astype(
        np.float32)
    u = (r.normal(size=(K, 2, cfg.n, cfg.n))
         + 1j * r.normal(size=(K, 2, cfg.n, cfg.n))).astype(np.complex64)
    other = jpp.plan_from_config(
        _jax_cfg(dataclasses.replace(cfg, distance=0.04)), 1.0)
    tfs = tuple(np.stack([p._np[k] for p in (jplan, other)])
                for k in jplan._plane_keys)
    key = jax.random.PRNGKey(5)
    want = jplan.apply_batch(jnp.asarray(phis), jnp.asarray(u), rng=key,
                             tfs=tuple(jnp.asarray(t) for t in tfs),
                             per_candidate_inputs=True)
    draws = [d for kk in jax.random.split(key, K)
             for d in _draws(kk, [(32, 32, 8)] * cfg.depth)]
    rp = _replay(monkeypatch, draws)
    got = plan.apply_batch(torch.from_numpy(phis), torch.from_numpy(u),
                           rng=_gen(), tfs=tuple(torch.from_numpy(t)
                                                 for t in tfs),
                           per_candidate_inputs=True)
    rp.done()
    assert _rel(got.numpy(), want) <= RTOL


def test_apply_batch_rgb_phase_stacks():
    cfg, plan, jplan, _, _ = _plan_inputs()
    r = np.random.default_rng(2)
    phis = r.uniform(0, 2 * np.pi, (2, cfg.depth, 3, cfg.n, cfg.n)).astype(
        np.float32)
    u = (r.normal(size=(2, 3, cfg.n, cfg.n))
         + 1j * r.normal(size=(2, 3, cfg.n, cfg.n))).astype(np.complex64)
    got = plan.apply_batch(torch.from_numpy(phis), torch.from_numpy(u))
    want = jplan.apply_batch(jnp.asarray(phis), jnp.asarray(u))
    assert got.shape == (2, 2, 3, cfg.n, cfg.n)
    assert _rel(got.numpy(), want) <= RTOL


# ------------------------------------------------------------ emulate_batch
def _cls_cfgs(**extra):
    base = dict(n=48, depth=3, det_size=6)
    return [DONNConfig(name=f"c{i}", pixel_size=ps, wavelength=wl,
                       distance=D, **{**base, **extra})
            for i, (ps, wl, D) in enumerate(GEOS)]


def _hold_batch(cfgs, tparams, jparams, x, rng=None, train=False,
                jrng=None, tol=RTOL):
    """emulate_batch in the port against the reference's, and against K
    sequential ``build_model(c).apply`` calls in the port."""
    kw = dict(train=True) if train else {}
    want = np.asarray(jemulate([_jax_cfg(c) for c in cfgs], jparams,
                               jnp.asarray(x), rng=jrng, **kw))
    got = emulate_batch(cfgs, tparams, x, rng=rng, device=CPU, **kw)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= tol
    return got


@pytest.mark.parametrize("kw", [{}, {"use_pallas": True},
                                {"codesign": "qat", "device_levels": 16},
                                {"tf_dtype": "bfloat16"},
                                {"tf_dtype": "bfloat16", "use_pallas": True}],
                         ids=["plain", "pallas", "qat", "bf16_planes",
                              "pallas_bf16_planes"])
def test_emulate_batch_classify_matches_reference_and_sequential(kw):
    cfgs = _cls_cfgs(**kw)
    jp = jbuild(_jax_cfg(cfgs[0])).init(jax.random.PRNGKey(0))
    tp = _params(jp)
    x = _digits(seed=0)
    got = _hold_batch(cfgs, tp, jp, x)
    for c, row in zip(cfgs, got):
        seq = build_model(c, device=CPU).apply(tp, torch.from_numpy(x))
        assert _rel(row.numpy(), seq.numpy()) <= SAME


def test_emulate_batch_per_candidate_params():
    cfgs = _cls_cfgs()
    m0 = jbuild(_jax_cfg(cfgs[0]))
    jps = [m0.init(jax.random.PRNGKey(k)) for k in range(len(cfgs))]
    _hold_batch(cfgs, [_params(p) for p in jps], jps, _digits(seed=1))


@pytest.mark.parametrize("shared", [True, False])
def test_emulate_batch_rng_split_matches_reference(shared, monkeypatch):
    cfgs = _cls_cfgs(codesign="gumbel", device_levels=16)
    m0 = jbuild(_jax_cfg(cfgs[0]))
    if shared:
        jps = m0.init(jax.random.PRNGKey(0))
        tps = _params(jps)
    else:
        jps = [m0.init(jax.random.PRNGKey(k)) for k in range(3)]
        tps = [_params(p) for p in jps]
    key = jax.random.PRNGKey(7)
    draws = [d for kk in jax.random.split(key, 3)
             for d in _draws(kk, [(48, 48, 16)] * 3)]
    rp = _replay(monkeypatch, draws)
    _hold_batch(cfgs, tps, jps, _digits(seed=2), rng=_gen(), jrng=key)
    rp.done()  # candidate by candidate, layer by layer


@pytest.mark.parametrize("use_pallas", [False, True])
def test_emulate_batch_multichannel_matches_reference(use_pallas):
    cfgs = [DONNConfig(name=f"m{i}", n=32, depth=3, det_size=6, channels=3,
                       num_classes=6, pixel_size=ps, distance=D,
                       use_pallas=use_pallas)
            for i, (ps, D) in enumerate([(36e-6, 0.05), (30e-6, 0.04)])]
    jp = jbuild(_jax_cfg(cfgs[0])).init(jax.random.PRNGKey(0))
    x = tsyn.synth_rgb_scenes(4, seed=0, size=32)[0]
    got = _hold_batch(cfgs, _params(jp), jp, x)
    assert got.shape == (2, 4, 6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_emulate_batch_segmentation_skip_train_matches_reference(use_pallas):
    cfgs = [DONNConfig(name=f"s{i}", n=32, depth=3, segmentation=True,
                       skip_from=0, layer_norm=True, pixel_size=ps,
                       distance=D, use_pallas=use_pallas)
            for i, (ps, D) in enumerate([(36e-6, 0.05), (32e-6, 0.045)])]
    jp = jbuild(_jax_cfg(cfgs[0])).init(jax.random.PRNGKey(1))
    x = tsyn.synth_seg(4, seed=0, size=32)[0]
    got = _hold_batch(cfgs, _params(jp), jp, x, train=True)
    for c, row in zip(cfgs, got):
        seq = build_model(c, device=CPU).apply(_params(jp),
                                               torch.from_numpy(x),
                                               train=True)
        assert _rel(row.numpy(), seq.numpy()) <= 1e-5


def test_emulate_batch_segmentation_rng(monkeypatch):
    cfgs = [DONNConfig(name=f"s{i}", n=32, depth=3, segmentation=True,
                       skip_from=1, layer_norm=True, pixel_size=ps,
                       distance=D, codesign="gumbel", device_levels=8)
            for i, (ps, D) in enumerate([(36e-6, 0.05), (32e-6, 0.045)])]
    jp = jbuild(_jax_cfg(cfgs[0])).init(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(9)
    draws = [d for kk in jax.random.split(key, 2)
             for d in _draws(kk, [(32, 32, 8)] * 3)]
    rp = _replay(monkeypatch, draws)
    _hold_batch(cfgs, _params(jp), jp, tsyn.synth_seg(4, seed=1, size=32)[0],
                rng=_gen(), train=True, jrng=key)
    rp.done()


def test_emulate_batch_phase_gradients_match_reference():
    """d/dphase of a batched pass against the reference's per-candidate
    gradients (its ``emulate_batch`` is a compiled executable)."""
    cfgs = _cls_cfgs(use_pallas=True)
    m0 = jbuild(_jax_cfg(cfgs[0]))
    jps = [m0.init(jax.random.PRNGKey(k)) for k in range(3)]
    x = _digits(seed=5)
    leaves = [{k: v.clone().requires_grad_(True)
               for k, v in _params(p)["phase"].items()} for p in jps]
    out = emulate_batch(cfgs, [{"phase": lv} for lv in leaves], x, device=CPU)
    grads = torch.autograd.grad(torch.sum(out ** 2),
                                [v for lv in leaves for v in lv.values()])
    it = iter(grads)
    for c, jp, lv in zip(cfgs, jps, leaves):
        jm = jbuild(_jax_cfg(c))
        wg = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2))(jp)
        for k in lv:
            assert _rel(next(it).numpy(), wg["phase"][k]) <= RTOL, k


def test_emulate_batch_statics_mismatch_raises():
    cfgs = _cls_cfgs()
    bad = dataclasses.replace(cfgs[1], num_classes=6)
    params = build_model(cfgs[0], device=CPU).init(_gen())
    with pytest.raises(ValueError, match="statics"):
        emulate_batch([cfgs[0], bad], params, _digits(), device=CPU)


def test_emulate_batch_mixed_depth_needs_per_candidate_params():
    cfgs = _cls_cfgs()
    deeper = dataclasses.replace(cfgs[1], depth=4)
    params = build_model(cfgs[0], device=CPU).init(_gen())
    with pytest.raises(ValueError, match="per-candidate params"):
        emulate_batch([cfgs[0], deeper], params, _digits(), device=CPU)


def test_emulate_batch_empty_and_param_count_checks():
    cfgs = _cls_cfgs()
    params = build_model(cfgs[0], device=CPU).init(_gen())
    with pytest.raises(ValueError):
        emulate_batch([], params, _digits(), device=CPU)
    with pytest.raises(ValueError):
        emulate_batch(cfgs, [params], _digits(), device=CPU)


def test_emulate_batch_inputs_hit_across_calls():
    """The reference's executable-reuse test, in eager terms: a warm call
    rebuilds no plan and no stacked candidate inputs."""
    tmod.clear_emulation_caches()
    cfgs = _cls_cfgs()
    params = build_model(cfgs[0], device=CPU).init(_gen())
    x = _digits(seed=4)
    emulate_batch(cfgs, params, x, device=CPU)
    s0, b0 = tpp.plan_cache_stats(), dict(tmod._BATCH_INPUT_STATS)
    emulate_batch(cfgs, params, x, device=CPU)
    s1 = tpp.plan_cache_stats()
    assert s1["misses"] == s0["misses"] and s1["hits"] == s0["hits"] + 1
    assert tmod._BATCH_INPUT_STATS == {
        "hits": b0["hits"] + 1, "misses": b0["misses"],
        "device_builds": b0["device_builds"]}


def test_emulate_batch_batched_inputs_memoized():
    tmod.clear_emulation_caches()
    cfgs = _cls_cfgs()
    params = build_model(cfgs[0], device=CPU).init(_gen())
    x = _digits(seed=7)
    emulate_batch(cfgs, params, x, device=CPU)
    misses = tmod._BATCH_INPUT_STATS["misses"]
    emulate_batch(cfgs, params, x, device=CPU)
    assert tmod._BATCH_INPUT_STATS["misses"] == misses
    assert tmod._BATCH_INPUT_STATS["hits"] >= 1
    emulate_batch(cfgs[:2], params, x, device=CPU)
    assert tmod._BATCH_INPUT_STATS["misses"] == misses + 1


def _pad_planes(planes, depth: int, pad_to: int):
    """A depth-``depth`` plan's (depth+1, N, N) host stack padded to
    (pad_to+1, N, N): copies of the final-hop plane between the layer
    gaps and the final hop, which stays at index ``pad_to``."""
    dummy = np.repeat(planes[depth:depth + 1], pad_to - depth, axis=0)
    return np.concatenate([planes[:depth], dummy, planes[depth:]], axis=0)


def _transfer(a, b, polar: bool):
    """A plane pair as complex128 H: ``amp * exp(j theta)`` or
    ``hr + j hi`` (theta is never compared: it is arbitrary where amp is
    0 and wraps at +-pi)."""
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return b * np.exp(1j * a) if polar else a + 1j * b


def _host_planes(c, depth: int, keys):
    """Candidate ``c``'s planes from its own host plan, depth-padded."""
    plan = tpp.plan_from_config(c, 1.0)
    return [_pad_planes(plan._np[k], c.depth, depth) for k in keys]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_batched_inputs_keep_the_template_plane_convention(use_pallas):
    """bf16 storage is the f32 build cast, and the f32 build holds each
    candidate's planes in the template's convention.  The f32 build is
    not numpy's to the bit, so its bf16 cast may sit one bf16 ulp from
    the planes ``build_model(c).apply`` casts (see
    ``test_bf16_batched_planes_within_one_ulp_of_the_sequential_planes``)
    and emulate_batch need not equal sequential emulation to the bit in
    bf16."""
    f32 = [dataclasses.replace(c, depth=d)
           for c, d in zip(_cls_cfgs(use_pallas=use_pallas), (2, 3, 2))]
    cfgs = [dataclasses.replace(c, tf_dtype="bfloat16") for c in f32]
    template = tpp.plan_from_config(cfgs[1], 1.0)
    (a, b), src, skip = tmod._batched_inputs(cfgs, cfgs[0], 1.0, template,
                                             False, torch.device(CPU))
    assert a.shape == (4, 3, 48, 48) and a.dtype == torch.bfloat16
    assert src.shape == (3, 48, 48) and skip is None
    (a32, b32), _, _ = tmod._batched_inputs(
        f32, f32[0], 1.0, tpp.plan_from_config(f32[1], 1.0), False,
        torch.device(CPU))
    assert torch.equal(a, a32.to(torch.bfloat16))
    assert torch.equal(b, b32.to(torch.bfloat16))
    for k, c in enumerate(f32):
        want = _transfer(*_host_planes(c, 3, template._plane_keys),
                         use_pallas)
        got = _transfer(a32[:, k], b32[:, k], use_pallas)
        assert np.max(np.abs(got - want)) <= 1e-6, k


def _bf16_ulps(got, want):
    """Elementwise distance in bf16 ulps (+0 and -0 are one value)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_batched_planes_within_one_ulp_of_the_sequential_planes(
        use_pallas):
    """In bf16 a set's planes are the f32 build cast, and the planes that
    ``build_model(c).apply`` uses are its numpy plan's f32 planes cast.
    The f32 builds differ by up to 1e-6, so the casts may round one bf16
    ulp apart, never more (theta only where amp > 0: it is arbitrary
    where amp is 0); the logits hold at that too."""
    cfgs = [dataclasses.replace(c, n=96, tf_dtype="bfloat16")
            for c in _cls_cfgs(use_pallas=use_pallas)]
    template = tpp.plan_from_config(cfgs[0], 1.0)
    tmod.clear_emulation_caches()
    planes, _, _ = tmod._batched_inputs(cfgs, cfgs[0], 1.0, template, False,
                                        torch.device(CPU))
    keys = template._plane_keys
    for k, c in enumerate(cfgs):
        host = tpp.plan_from_config(c, 1.0)._np
        live = torch.ones(planes[0][:, k].shape, dtype=torch.bool)
        if use_pallas:
            live = torch.from_numpy(host["amp"]) > 0
        for key, got in zip(keys, planes):
            want = torch.from_numpy(host[key]).to(torch.bfloat16)
            assert int(_bf16_ulps(got[:, k], want)[live].max()) <= 1, (k, key)
    x = _digits(seed=3)
    p = build_model(cfgs[0], device=CPU).init(_gen())
    got = tmod.emulate_batch(cfgs, p, x, device=CPU)
    for c, row in zip(cfgs, got):
        seq = build_model(c, device=CPU).apply(p, torch.from_numpy(x))
        assert _rel(row.numpy(), seq.numpy()) <= SAME


@pytest.mark.parametrize("method,use_pallas,pad", [
    ("rs", False, False), ("rs", True, False), ("rs", True, True),
    ("fresnel", True, False), ("fresnel", False, True),
    ("fraunhofer", True, False)])
def test_ragged_depth_batched_inputs_equal_padded_host_plans(method,
                                                             use_pallas, pad):
    """A ragged-depth set's stacked planes are each candidate's own host
    plan's, padded to the deepest; sources are the default laser's.
    Fraunhofer sets are built on the host, bit for bit."""
    geos = [(36e-6, 532e-9, 0.30, 2), (30e-6, 432e-9, 0.25, 5),
            (40e-6, 632e-9, 0.35, 3)]
    cfgs = [DONNConfig(name=f"r{i}", n=24, det_size=4, pixel_size=ps,
                       wavelength=wl, depth=d, approximation=method,
                       distances=tuple(D * (1.0 + 0.1 * g)
                                       for g in range(d + 1)),
                       use_pallas=use_pallas, pad=pad)
            for i, (ps, wl, D, d) in enumerate(geos)]
    with warnings.catch_warnings():
        # fraunhofer at these distances is near field: the validator warns
        warnings.simplefilter("ignore")
        template = tpp.plan_from_config(cfgs[1], 1.0)
        tmod.clear_emulation_caches()
        (a, b), src, _ = tmod._batched_inputs(cfgs, cfgs[0], 1.0, template,
                                              False, torch.device(CPU))
        keys = template._plane_keys
        n = 48 if pad and method != "fraunhofer" else 24
        assert a.shape == (6, 3, n, n) and a.dtype == torch.float32
        for k, c in enumerate(cfgs):
            want = _host_planes(c, 5, keys)
            if method == "fraunhofer":
                assert torch.equal(a[:, k], torch.from_numpy(want[0]))
                assert torch.equal(b[:, k], torch.from_numpy(want[1]))
            else:
                gap = np.abs(_transfer(a[:, k], b[:, k], use_pallas)
                             - _transfer(*want, use_pallas))
                assert np.max(gap) <= 1e-6, k
            field = Laser(wavelength=c.wavelength).field(
                tdf.Grid(c.n, c.pixel_size))
            assert torch.equal(src[k], torch.from_numpy(field))
    built = 0 if method == "fraunhofer" else 1
    assert tmod._BATCH_INPUT_STATS == {"hits": 0, "misses": 1,
                                       "device_builds": built}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_segmentation_skip_pair_equals_host_planes(use_pallas):
    """The skip hop's planes (one row a candidate, from the same build)
    are the host's planes over the rest of the distance to the detector
    plane."""
    cfgs = [DONNConfig(name=f"s{i}", n=32, depth=3, segmentation=True,
                       skip_from=1, layer_norm=True, pixel_size=ps,
                       distances=(D, 1.1 * D, 1.2 * D, 1.3 * D),
                       use_pallas=use_pallas)
            for i, (ps, D) in enumerate([(36e-6, 0.05), (32e-6, 0.045)])]
    template = tpp.plan_from_config(cfgs[0], 1.0)
    tfs, _, skip = tmod._batched_inputs(cfgs, cfgs[0], 1.0, template, True,
                                        torch.device(CPU))
    assert [t.shape for t in skip] == [(2, 32, 32)] * 2
    assert tfs[0].shape == (4, 2, 32, 32)
    for k, c in enumerate(cfgs):
        want = tpp.transfer_planes(tdf.Grid(c.n, c.pixel_size),
                                   float(sum(c.gap_distances()[2:])),
                                   c.wavelength)
        got = _transfer(skip[0][k], skip[1][k], use_pallas)
        keys = template._plane_keys
        gap = np.abs(got - _transfer(want[keys[0]], want[keys[1]],
                                     use_pallas))
        assert np.max(gap) <= 1e-6, k


def test_invalid_candidate_raises_before_any_plane_is_built():
    """Every candidate is validated, not only the template: one invalid
    geometry raises ``PhysicsValidationError``, one that keeps almost no
    spectrum warns, and neither is skipped for a set built on the card."""
    tmod.clear_emulation_caches()
    cfgs = _cls_cfgs()
    params = build_model(cfgs[0], device=CPU).init(_gen())
    bad = cfgs[:2] + [dataclasses.replace(cfgs[2], distance=-0.05)]
    with pytest.raises(PhysicsValidationError, match="geometry"):
        emulate_batch(bad, params, _digits(), device=CPU)
    assert tmod._BATCH_INPUT_STATS["device_builds"] == 0
    # 8 um pitch at 30 m: the band limit keeps under 10% of Nyquist
    far = cfgs[:2] + [dataclasses.replace(cfgs[2], pixel_size=8e-6,
                                          distance=30.0)]
    with pytest.warns(PhysicsWarning, match="band-limit-collapse"):
        emulate_batch(far, params, _digits(), device=CPU)
    assert tmod._BATCH_INPUT_STATS["device_builds"] == 1


def test_device_builds_count_misses_and_never_hits():
    """``device_builds`` rises by one a miss built by the batched kernel
    path, and not on a hit nor on a fraunhofer set built on the host; the
    candidates leave no entry in the TF cache (the template's plan does)."""
    tmod.clear_emulation_caches()
    tpp.clear_tf_cache()
    cfgs = _cls_cfgs()
    params = build_model(cfgs[0], device=CPU).init(_gen())
    x = _digits(seed=3)
    emulate_batch(cfgs, params, x, device=CPU)
    assert tmod._BATCH_INPUT_STATS == {"hits": 0, "misses": 1,
                                       "device_builds": 1}
    assert tpp.tf_cache_stats()["misses"] == 1  # the template's one gap
    emulate_batch(cfgs, params, x, device=CPU)
    assert tmod._BATCH_INPUT_STATS == {"hits": 1, "misses": 1,
                                       "device_builds": 1}
    emulate_batch(cfgs[1:], params, x, device=CPU)
    assert tmod._BATCH_INPUT_STATS == {"hits": 1, "misses": 2,
                                       "device_builds": 2}
    far = [dataclasses.replace(c, approximation="fraunhofer") for c in cfgs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # near field for fraunhofer
        emulate_batch(far, params, x, device=CPU)
    assert tmod._BATCH_INPUT_STATS == {"hits": 1, "misses": 3,
                                       "device_builds": 2}
    tmod.clear_emulation_caches()
    assert tmod._BATCH_INPUT_STATS == {"hits": 0, "misses": 0,
                                       "device_builds": 0}


# mixed depth (tests/test_hetero.py::TestMixedDepthEmulateBatch)
def _depth_cfgs(depths=(2, 3, 5), **extra):
    return [DONNConfig(name=f"d{d}", n=48, det_size=6, depth=d,
                       distance=0.05, **extra) for d in depths]


@pytest.mark.parametrize("kw", [{}, {"codesign": "qat", "device_levels": 16},
                                {"use_pallas": True}],
                         ids=["plain", "qat", "pallas"])
def test_mixed_depth_matches_reference_per_candidate(kw):
    cfgs = _depth_cfgs(**kw)
    jps = [jbuild(_jax_cfg(c)).init(jax.random.PRNGKey(i))
           for i, c in enumerate(cfgs)]
    tps = [_params(p) for p in jps]
    x = _digits(seed=1)
    got = _hold_batch(cfgs, tps, jps, x)
    for c, p, row in zip(cfgs, tps, got):
        seq = build_model(c, device=CPU).apply(p, torch.from_numpy(x))
        assert _rel(row.numpy(), seq.numpy()) <= SAME


def test_mixed_depth_rng_draws_over_the_padded_depth(monkeypatch):
    cfgs = _depth_cfgs((2, 4), codesign="gumbel", device_levels=8)
    jps = [jbuild(_jax_cfg(c)).init(jax.random.PRNGKey(i))
           for i, c in enumerate(cfgs)]
    key = jax.random.PRNGKey(2)
    draws = [d for kk in jax.random.split(key, 2)
             for d in _draws(kk, [(48, 48, 8)] * 4)]
    rp = _replay(monkeypatch, draws)
    _hold_batch(cfgs, [_params(p) for p in jps], jps, _digits(seed=3),
                rng=_gen(), jrng=key)
    rp.done()


def test_mixed_depth_and_geometry():
    cfgs = [
        DONNConfig(name="a", n=48, det_size=6, depth=2, distance=0.04,
                   wavelength=532e-9),
        DONNConfig(name="b", n=48, det_size=6, depth=4, distance=0.06,
                   wavelength=633e-9, pixel_size=30e-6),
    ]
    jps = [jbuild(_jax_cfg(c)).init(jax.random.PRNGKey(i))
           for i, c in enumerate(cfgs)]
    _hold_batch(cfgs, [_params(p) for p in jps], jps, _digits(seed=2))


def test_skip_from_ignored_without_segmentation():
    cfgs = [dataclasses.replace(c, skip_from=5)
            for c in _depth_cfgs(depths=(2, 3))]
    jps = [jbuild(_jax_cfg(c)).init(jax.random.PRNGKey(i))
           for i, c in enumerate(cfgs)]
    _hold_batch(cfgs, [_params(p) for p in jps], jps, _digits(seed=6))


def test_heterogeneous_layer_configs_rejected():
    cfg = DONNConfig(name="h", n=48, depth=3, distance=0.05, det_size=6,
                     layers=HETERO_RNG)
    params = build_model(cfg, device=CPU).init(_gen())
    with pytest.raises(ValueError, match="per-candidate-uniform"):
        emulate_batch([cfg], [params], _digits(), device=CPU)


# ------------------------------------------------------------ caches
def test_cached_apply_matches_model_apply_and_reuses_the_model():
    cfg = DONNConfig(name="ca", n=48, depth=3, det_size=6)
    model = build_model(cfg, device=CPU)
    params = model.init(_gen())
    x = _digits(seed=5)
    fn = cached_apply(cfg, device=CPU)
    assert torch.equal(fn(params, x), model.apply(params,
                                                  torch.from_numpy(x)))
    hits = tmod._MODEL_STATS["hits"]
    cached_apply(DONNConfig(name="other-name", n=48, depth=3, det_size=6),
                 device=CPU)(params, _digits(8, seed=1))
    assert tmod._MODEL_STATS["hits"] == hits + 1


def test_cached_apply_rng_variant(monkeypatch):
    """``TestCachedApply::test_rng_variant`` (qat ignores the generator),
    and the Gumbel case, whose draws come from it."""
    cfg = DONNConfig(name="ca3", n=48, depth=3, det_size=6, codesign="qat",
                     device_levels=32)
    model = build_model(cfg, device=CPU)
    params = model.init(_gen())
    x = _digits(seed=6)
    assert torch.equal(cached_apply(cfg, device=CPU)(params, x, _gen(3)),
                       model.apply(params, torch.from_numpy(x), _gen(3)))
    g = dataclasses.replace(cfg, codesign="gumbel")
    jm = jbuild(_jax_cfg(g))
    key = jax.random.PRNGKey(3)
    want = jm.apply(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
                    jnp.asarray(x), key)
    rp = _replay(monkeypatch, _draws(key, _shapes(g)))
    got = cached_apply(g, device=CPU)(params, x, _gen())
    rp.done()
    assert _rel(got.numpy(), want) <= RTOL


def test_cached_model_shares_instances_by_config_and_device():
    base = dict(n=48, depth=3, det_size=6)
    a = cached_model(DONNConfig(name="x1", **base), device=CPU)
    assert a is cached_model(DONNConfig(name="x2", **base), device=CPU)
    assert a is not cached_model(DONNConfig(name="x1", distance=0.31,
                                            **base), device=CPU)
    from repro_torch.core.laser import Laser

    cfg = DONNConfig(name="cm3", **base)
    lz = Laser(wavelength=cfg.wavelength)
    assert cached_model(cfg, laser=lz, device=CPU) is not cached_model(
        cfg, laser=lz, device=CPU)
    assert tmod.model_cache_key(a) == tmod.config_static_key(a.cfg)
    assert tmod.model_cache_key(build_model(
        cfg, Laser(wavelength=cfg.wavelength, profile="gaussian"),
        device=CPU)) is None


def test_models_share_the_cached_plan():
    tpp.clear_plan_cache()
    cfg = DONNConfig(name="ps", n=48, depth=3, det_size=6)
    assert build_model(cfg, device=CPU).plan is build_model(
        cfg, device=CPU).plan
    assert tpp.plan_cache_stats()["hits"] >= 1


# ------------------------------------------------------------ remat
def _remat_pair(remat, **kw):
    tm, tp, jm, jp = _pair(**kw)
    cfgr = dataclasses.replace(tm.cfg, remat=remat)
    return tm, build_model(cfgr, device=CPU), tp, jbuild(_jax_cfg(cfgr)), jp


def _loss_grads(model, params, x, rng=None):
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in params["phase"].items()}
    loss = torch.sum(model.apply({"phase": leaves}, x, rng))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("remat", ["layer", "segment"])
@pytest.mark.parametrize("kw", [{}, {"use_pallas": True}],
                         ids=["plain", "pallas"])
def test_remat_values_and_grads_match_none_and_reference(remat, kw):
    m0, mr, tp, jmr, jp = _remat_pair(remat, **kw)
    x = torch.from_numpy(_digits(seed=2))
    l0, g0 = _loss_grads(m0, tp, x)
    lr, gr = _loss_grads(mr, tp, x)
    assert abs(lr - l0) <= SAME * abs(l0)
    jl, jg = jax.value_and_grad(
        lambda p: jnp.sum(jmr.apply(p, jnp.asarray(x.numpy()))))(jp)
    assert abs(lr - float(jl)) <= RTOL * abs(float(jl))
    for k in g0:
        assert _rel(gr[k].numpy(), g0[k].numpy()) <= SAME, k
        assert _rel(gr[k].numpy(), jg["phase"][k]) <= RTOL, k


@pytest.mark.parametrize("remat,extra", [("layer", 6), ("segment", 6),
                                         ("none", 0)])
def test_remat_recomputes_the_forward_in_the_backward(remat, extra,
                                                      monkeypatch):
    """The backward re-runs each layer's two K1 passes (here their plain
    versions) under remat, and nothing more; the fused hop's saved tensors
    come from that recompute."""
    _, mr, tp, _, _ = _remat_pair(remat, use_pallas=True)
    calls = []
    real = kref.conj_phase_scale_ref
    monkeypatch.setattr(kref, "conj_phase_scale_ref",
                        lambda *a: calls.append(1) or real(*a))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tp["phase"].items()}
    loss = torch.sum(mr.apply({"phase": leaves},
                              torch.from_numpy(_digits(seed=2))))
    fwd = len(calls)
    torch.autograd.grad(loss, list(leaves.values()))
    assert fwd == 6 and len(calls) - fwd == extra


def test_remat_reuses_the_forward_draws(monkeypatch):
    m0, mr, tp, jmr, jp = _remat_pair("layer", codesign="gumbel",
                                      device_levels=8)
    x = _digits(seed=4)
    key = jax.random.PRNGKey(1)
    draws = _draws(key, [(32, 32, 8)] * 3)
    rp = _replay(monkeypatch, draws)
    lr, gr = _loss_grads(mr, tp, torch.from_numpy(x), _gen())
    rp.done()  # three draws: the recompute draws nothing
    jl, jg = jax.value_and_grad(
        lambda p: jnp.sum(jmr.apply(p, jnp.asarray(x), key)))(jp)
    assert abs(lr - float(jl)) <= RTOL * abs(float(jl))
    for k in gr:
        assert _rel(gr[k].numpy(), jg["phase"][k]) <= RTOL, k


def test_segment_remat_heterogeneous():
    layers = (LayerSpec(distance=0.05, size=48),
              LayerSpec(distance=0.05, size=48),
              LayerSpec(distance=0.05, size=32, pixel_size=54e-6))
    m0, mr, tp, jmr, jp = _remat_pair("segment", n=48, depth=3,
                                      layers=layers)
    x = torch.from_numpy(_digits(2, seed=3))
    _, g0 = _loss_grads(m0, tp, x)
    _, gr = _loss_grads(mr, tp, x)
    jg = jax.grad(lambda p: jnp.sum(jmr.apply(p, jnp.asarray(x.numpy()))))(jp)
    for k in g0:
        assert _rel(gr[k].numpy(), g0[k].numpy()) <= SAME, k
        assert _rel(gr[k].numpy(), jg["phase"][k]) <= RTOL, k


def test_invalid_remat_rejected():
    with pytest.raises(ValueError, match="remat"):
        DONNConfig(name="bad", remat="everything")
    with pytest.raises(ValueError, match="remat"):
        tpp.PropagationPlan(tpp.df.Grid(8, 36e-6), (0.05, 0.05), 532e-9,
                            remat="everything")


# ------------------------------------------------------------ training
def _train(cfg, steps, steps_per_call, rng, **kw):
    model = build_model(cfg, device=CPU)
    jm = jbuild(_jax_cfg(cfg))
    params = _params(jm.init(jax.random.PRNGKey(0)))
    xs, ys = tsyn.synth_digits(256, seed=0)
    return ttu.train_classifier(
        model, params, tsyn.batch_iterator(xs, ys, 8, seed=1), steps=steps,
        lr=0.3, steps_per_call=steps_per_call, prefetch=0, rng=rng, **kw)


def _train_draws(cfg, key, steps):
    """The reference's rng chain: ``rng, sub = split(rng)`` before each
    step (``train_utils.py:157,288``), then the per-layer split of sub."""
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws += _draws(sub, _shapes(cfg))
    return draws


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_gumbel_training_matches_reference(steps_per_call, monkeypatch):
    """``tests/test_train_throughput.py:65``: per-step and chunked (2 + a
    partial 1) gumbel training on one rng chain, against the reference's
    losses.  Parameters are held port against port below, not against
    the reference: AdamW's first steps move each phase by lr * g / (|g| +
    eps), a full +-lr wherever |g| >> eps, and the saturated 256-level
    softmax leaves most phase gradients so small that their sign sits
    below the f32 rounding of the two FFT builds."""
    cfg = DONNConfig(name="tg", n=48, depth=3, distance=0.05, det_size=6,
                     codesign="gumbel")
    jm = jbuild(_jax_cfg(cfg))
    xs, ys = tsyn.synth_digits(256, seed=0)
    key = jax.random.PRNGKey(3)
    want = jtu.train_classifier(
        jm, jm.init(jax.random.PRNGKey(0)),
        tsyn.batch_iterator(xs, ys, 8, seed=1), steps=3, lr=0.3,
        needs_rng=True, rng=key, steps_per_call=steps_per_call)
    rp = _replay(monkeypatch, _train_draws(cfg, key, 3))
    got = _train(cfg, 3, steps_per_call, _gen(), needs_rng=True)
    rp.done()
    assert len(got.losses) == 3
    assert _rel(got.losses, want.losses) <= RTOL


def test_gumbel_chunked_equals_per_step_under_one_generator():
    cfg = DONNConfig(name="tg2", n=32, depth=3, distance=0.05, det_size=6,
                     codesign="gumbel", device_levels=16)
    ref = _train(cfg, 6, 1, _gen(5), needs_rng=True)
    got = _train(cfg, 6, 4, _gen(5), needs_rng=True)  # 4 + a partial 2
    assert np.array_equal(ref.losses, got.losses)
    for k, v in got.params["phase"].items():
        assert torch.equal(v, ref.params["phase"][k]), k


def test_needs_rng_requires_a_generator():
    cfg = DONNConfig(name="tg3", n=32, depth=2, distance=0.05, det_size=6,
                     codesign="gumbel", device_levels=8)
    model = build_model(cfg, device=CPU)
    params = model.init(_gen())
    step = ttu.make_train_step(model, ttu.AdamW(lr=0.1), 10, needs_rng=True)
    x, y = tsyn.synth_digits(4, seed=0)
    with pytest.raises(TypeError, match="Generator"):
        step(params, ttu.AdamW(lr=0.1).init(params), 0, x, y)
    # without needs_rng the generator is not drawn from
    g = _gen(2)
    before = g.get_state()
    ttu.make_train_step(model, ttu.AdamW(lr=0.1), 10)(
        params, ttu.AdamW(lr=0.1).init(params), 0, x, y, g)
    assert torch.equal(g.get_state(), before)
