"""The port's one-shot physics against the paper's physics and the JAX package.

Every case of tests/test_diffraction.py runs on the port
(``repro_torch.core.diffraction``) at the reference's grids and
tolerances: unitarity, the band limit, two hops equal one, forward then
backward, the Gaussian waist against theory, Fresnel against RS in the
paraxial regime, superposition, the slit's sinc far field, phase
gradients and the pre-shifted planes.  Each propagation is also held to
the JAX function's on the same numpy input, within 1e-5 of its max (f32).

Then the names that complete the port's surface, each against the
reference's value: the LightPipes-style baseline, the whole-hop plain
reference and the fused hop's CPU path, the transfer-plane cache
counters, the device presets, ``segment_slices``,
``Detector.intensity_image``, ``fresnel_number``, ``phase_to_field``,
the LM registry's ``register``, the named DONN config functions, ``DONN_RULES``
and the DSL's hybrid stack of examples/advanced_donns.py.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import donn as jdonn  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import codesign as jcd  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import diffraction as jdf  # noqa: E402
from repro.core import dsl as jdsl  # noqa: E402
from repro.core import layers as jlayers  # noqa: E402
from repro.core import propagation as jpp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import config as jmconfig  # noqa: E402
from repro.runtime import donn_steps as jsteps  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.configs import donn as tdonn  # noqa: E402
from repro_torch.configs.donn import HYBRID_SLM_PRINTED  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import codesign as tcd  # noqa: E402
from repro_torch.core import diffraction as tdf  # noqa: E402
from repro_torch.core import dsl as tdsl  # noqa: E402
from repro_torch.core import layers as tlayers  # noqa: E402
from repro_torch.core import propagation as tpp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import config as tmconfig  # noqa: E402
from repro_torch.runtime import donn_steps as tsteps  # noqa: E402

WL = 532e-9
PX = 36e-6
JAX_RTOL = 1e-5  # of the reference output's max, f32
F32_TINY = float(np.finfo(np.float32).tiny)  # smallest normal f32


def _rand_field(n, seed=0, lead=()):
    r = np.random.default_rng(seed)
    shape = tuple(lead) + (n, n)
    return (r.normal(size=shape) + 1j * r.normal(size=shape)).astype(
        np.complex64)


def _near_jax(got: np.ndarray, want: np.ndarray) -> None:
    """The port's output within JAX_RTOL of the reference's max, plus the
    reference's flush floor.  XLA's CPU backend flushes subnormal values to
    zero, in its inputs and in every intermediate; the port keeps them.  A
    field scaled down to f32's subnormal range (superposition's a=0,
    b=F32_TINY) then propagates to zero there and to ~4e-38 here.  Flushing
    moves each input by under sqrt(2)*F32_TINY, and a propagation (|H| <= 1)
    sums an n-wide field's input with absolute weights of at most n, so the
    floor is 2n * F32_TINY, the rest left to the flushed intermediates:
    ~1e-36, nothing for a field of normal scale."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max()
    floor = 2 * got.shape[-1] * F32_TINY
    assert err <= JAX_RTOL * np.abs(want).max() + floor, err


def _prop(u, n, px, z, method=tdf.RS, band_limit=True, pad=False):
    """The port's ``propagate`` of the numpy field u, held to the
    reference's on the same input; returns the port's as numpy."""
    got = tdf.propagate(torch.from_numpy(u), tdf.Grid(n, px), z, WL,
                        method, band_limit, pad).numpy()
    want = np.asarray(jdf.propagate(jnp.asarray(u), jdf.Grid(n, px), z, WL,
                                    method, band_limit, pad))
    _near_jax(got, want)
    return got


def _energy(u: np.ndarray) -> float:
    return float(tdf.intensity(torch.from_numpy(u)).sum())


def _gaussian(n, px, w0):
    c = tdf.Grid(n, px).coords()
    xx, yy = np.meshgrid(c, c, indexing="ij")
    return np.exp(-(xx**2 + yy**2) / w0**2).astype(np.complex64), xx


# ------------------------------------------------------ energy conservation
def test_rs_unitary_without_band_limit():
    u = _rand_field(64)
    v = _prop(u, 64, PX, 0.01, tdf.RS, band_limit=False)
    np.testing.assert_allclose(_energy(u), _energy(v), rtol=1e-4)


def test_fresnel_unitary():
    u = _rand_field(64, 1)
    v = _prop(u, 64, PX, 0.05, tdf.FRESNEL, band_limit=False)
    np.testing.assert_allclose(_energy(u), _energy(v), rtol=1e-4)


def test_band_limit_only_removes_energy():
    u = _rand_field(64, 2)
    v = _prop(u, 64, PX, 0.3, tdf.RS, band_limit=True)
    assert _energy(v) <= _energy(u) * (1 + 1e-5)


# -------------------------------------------------------------- composition
@pytest.mark.parametrize("method", [tdf.RS, tdf.FRESNEL])
def test_two_hops_equal_one(method):
    u = _rand_field(48, 3)
    z1, z2 = 0.013, 0.021
    v2 = _prop(_prop(u, 48, PX, z1, method, False), 48, PX, z2, method, False)
    v1 = _prop(u, 48, PX, z1 + z2, method, False)
    np.testing.assert_allclose(v1, v2, rtol=2e-3, atol=2e-3)


def test_forward_backward_identity():
    u = _rand_field(48, 4)
    v = _prop(_prop(u, 48, PX, 0.02, tdf.RS, False), 48, PX, -0.02, tdf.RS,
              False)
    np.testing.assert_allclose(u, v, rtol=2e-3, atol=2e-3)


# ------------------------------------------------------ Gaussian beam theory
def test_waist_expansion_matches_theory():
    """w(z) = w0 sqrt(1 + (z/zR)^2) for a Gaussian beam."""
    n, px, w0 = 256, 8e-6, 120e-6
    u0, xx = _gaussian(n, px, w0)
    zr = math.pi * w0**2 / WL
    z = 1.5 * zr
    inten = tdf.intensity(torch.from_numpy(
        _prop(u0, n, px, z, tdf.RS, band_limit=False))).numpy()
    # I ~ exp(-2 r^2/w^2) => <x^2> = w^2/4 => w = 2 sqrt(<x^2>)
    w_meas = 2.0 * math.sqrt((inten * xx**2).sum() / inten.sum())
    w_theory = w0 * math.sqrt(1 + (z / zr) ** 2)
    assert abs(w_meas - w_theory) / w_theory < 0.05


def test_fresnel_matches_rs_in_paraxial_regime():
    n, px = 128, 16e-6
    u0, _ = _gaussian(n, px, 200e-6)
    i_rs = np.abs(_prop(u0, n, px, 0.05, tdf.RS)) ** 2
    i_fr = np.abs(_prop(u0, n, px, 0.05, tdf.FRESNEL)) ** 2
    assert np.corrcoef(i_rs.ravel(), i_fr.ravel())[0, 1] > 0.999


# ---------------------------------------------------------------- linearity
@settings(max_examples=10, deadline=None)
@given(a=st.floats(-2, 2), b=st.floats(-2, 2))
def test_superposition(a, b):
    u1, u2 = _rand_field(32, 5), _rand_field(32, 6)
    lhs = _prop((a * u1 + b * u2).astype(np.complex64), 32, PX, 0.02)
    rhs = a * _prop(u1, 32, PX, 0.02) + b * _prop(u2, 32, PX, 0.02)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------- Fraunhofer
def test_far_field_of_slit_is_sinc():
    n, px, slit_w, z = 256, 10e-6, 20, 2.0
    u = np.zeros((n, n), np.complex64)
    u[:, n // 2 - slit_w // 2: n // 2 + slit_w // 2] = 1.0
    far = _prop(u, n, px, z, tdf.FRAUNHOFER)
    np.testing.assert_array_equal(far, tdf.fraunhofer(
        torch.from_numpy(u), tdf.Grid(n, px), z, WL).numpy())
    row = (np.abs(far) ** 2)[n // 2]
    # central maximum at center; first zeros at x = lambda z / slit width
    assert row.argmax() == n // 2
    x = np.fft.fftshift(np.fft.fftfreq(n, d=px)) * WL * z
    iz = int(np.argmin(np.abs(x - WL * z / (slit_w * px))))
    assert row[iz] < 0.01 * row[n // 2]


# ---------------------------------------------------------------- gradients
def test_phase_gradients_flow_and_match_reference():
    g, u = tdf.Grid(32, PX), _rand_field(32, 7)
    h = tdf.transfer_function(g, 0.02, WL, tdf.RS)

    phi = torch.zeros((32, 32), requires_grad=True)
    v = tdf.propagate_tf(torch.from_numpy(u) * tdf.phase_to_field(phi),
                         torch.from_numpy(h))
    tdf.intensity(v)[:8, :8].sum().backward()
    got = phi.grad.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0

    def f(p):
        w = jdf.propagate_tf(jnp.asarray(u) * jdf.phase_to_field(p),
                             jnp.asarray(h))
        return jnp.sum(jdf.intensity(w)[:8, :8])

    _near_jax(got, np.asarray(jax.grad(f)(jnp.zeros((32, 32), jnp.float32))))


def test_gradients_through_one_shot_propagate():
    u = _rand_field(32, 8)
    phi0 = np.random.default_rng(9).uniform(0, 6.28, (32, 32)).astype(
        np.float32)
    phi = torch.from_numpy(phi0).requires_grad_()
    v = tdf.propagate(torch.from_numpy(u) * tdf.phase_to_field(phi),
                      tdf.Grid(32, PX), 0.02, WL, pad=True)
    tdf.intensity(v)[4:12, 4:12].sum().backward()

    def f(p):
        w = jdf.propagate(jnp.asarray(u) * jdf.phase_to_field(p),
                          jdf.Grid(32, PX), 0.02, WL, pad=True)
        return jnp.sum(jdf.intensity(w)[4:12, 4:12])

    _near_jax(phi.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(phi0))))


# --------------------------------------------------- pre-shifted and padded
def test_cached_plane_is_preshifted_centered_plane():
    g = tdf.Grid(64, PX)
    hc = tdf.fresnel_tf_centered(g, 0.05, WL)
    h = tdf.transfer_function(g, 0.05, WL, tdf.FRESNEL, band_limit=False)
    np.testing.assert_array_equal(np.fft.ifftshift(hc), h)
    np.testing.assert_array_equal(
        h, jdf.transfer_function(jdf.Grid(64, PX), 0.05, WL, jdf.FRESNEL,
                                 band_limit=False))


def test_fresnel_prefolded_shift_pair():
    u, z = _rand_field(64, 11), 0.05
    hc = tdf.fresnel_tf_centered(tdf.Grid(64, PX), z, WL)
    spec = np.fft.fftshift(np.fft.fft2(u))
    want = np.fft.ifft2(np.fft.ifftshift(spec * hc))
    got = _prop(u, 64, PX, z, tdf.FRESNEL, band_limit=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_padded_plane_preshifted_too():
    g = tdf.Grid(32, PX)
    hc = tdf.fresnel_tf_centered(g, 0.02, WL, pad=True)
    h = tdf.transfer_function(g, 0.02, WL, tdf.FRESNEL, band_limit=False,
                              pad=True)
    np.testing.assert_array_equal(np.fft.ifftshift(hc), h)


@pytest.mark.parametrize("method", [tdf.RS, tdf.FRESNEL])
@pytest.mark.parametrize("band_limit", [True, False])
def test_padded_propagate_is_a_linear_convolution(method, band_limit):
    """pad=True hops on the 2x grid and crops: a batch of fields, held to
    the reference and to the explicit pad -> hop -> crop."""
    u = _rand_field(40, 12, lead=(3,))
    got = _prop(u, 40, PX, 0.1, method, band_limit, pad=True)
    assert got.shape == (3, 40, 40)
    h = tdf.transfer_function(tdf.Grid(40, PX), 0.1, WL, method, band_limit,
                              pad=True)
    up = np.pad(u, [(0, 0), (20, 20), (20, 20)])
    want = np.fft.ifft2(np.fft.fft2(up) * h)[:, 20:60, 20:60]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- baseline engine
def test_lightpipes_like_matches_physics():
    """The deliberately-slow baseline must still be *correct*."""
    r = np.random.default_rng(0)
    u = r.normal(size=(2, 48, 48)) + 1j * r.normal(size=(2, 48, 48))
    ours = _prop(u.astype(np.complex64), 48, 36e-6, 0.02, tdf.RS,
                 band_limit=False)
    theirs = tbase.LightPipesLikeEngine(tdf.Grid(48, 36e-6), WL) \
        .propagate_batch(u, 0.02)
    np.testing.assert_allclose(ours, theirs.astype(np.complex64),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(
        theirs, jbase.LightPipesLikeEngine(jdf.Grid(48, 36e-6), WL)
        .propagate_batch(u, 0.02), rtol=1e-12, atol=1e-12)


# ------------------------------------------------- whole-hop plain reference
def _hop_inputs(seed, planes=()):
    r = np.random.default_rng(seed)
    x = _rand_field(24, seed, lead=(2,) + tuple(planes))
    shape = tuple(planes) + (24, 24)
    th_h, th_m = (r.uniform(-math.pi, math.pi, shape).astype(np.float32)
                  for _ in range(2))
    amp_h, amp_m = (r.uniform(0, 1, shape).astype(np.float32)
                    for _ in range(2))
    return x, th_h, amp_h, th_m, amp_m


def test_fused_spectral_hop_ref_matches_reference():
    args = _hop_inputs(13)
    got = tref.fused_spectral_hop_ref(*map(torch.from_numpy, args)).numpy()
    _near_jax(got, np.asarray(jref.fused_spectral_hop_ref(
        *map(jnp.asarray, args))))
    assert tops.fused_spectral_hop_ref is tref.fused_spectral_hop_ref


@pytest.mark.parametrize("planes", [(), (3,)], ids=["shared", "stack3"])
def test_fused_hop_plain_path_is_the_whole_hop(planes):
    """``ops.fused_spectral_hop`` on CPU tensors (its two K1 passes' plain
    versions) computes the unfused M . ifft2(Hc . fft2(x))."""
    args = tuple(map(torch.from_numpy, _hop_inputs(14, planes)))
    got = tops.fused_spectral_hop(*args)
    want = tref.fused_spectral_hop_ref(*args)
    err = (got - want).abs().max().item()
    assert err <= JAX_RTOL * want.abs().max().item()


def test_ops_aliases_are_the_plain_versions():
    for name in ("complex_mul_ref", "phase_apply_ref", "phase_tf_apply_ref",
                 "fused_spectral_hop_ref", "intensity_readout_ref",
                 "rope_ref", "selective_scan_ref"):
        assert getattr(tops, name) is getattr(tref, name)


# ------------------------------------------------- transfer-plane counters
def _cache_sequence(df, pp, smoke_cfg) -> list:
    df_grid = df.Grid(32, PX)
    pp.clear_plan_cache()
    pp.clear_tf_cache()
    seen = [pp.tf_cache_stats()]
    pp.transfer_planes(df_grid, 0.02, WL)
    pp.transfer_planes(df_grid, 0.02, WL)
    pp.cached_transfer_function(df_grid, 0.02, WL)
    pp.transfer_planes(df_grid, 0.02, WL, df.FRESNEL)
    pp.transfer_planes(df_grid, 0.02, WL, pad=True)
    pp.transfer_planes(df_grid, 0.02, WL, df.FRAUNHOFER)
    seen.append(pp.tf_cache_stats())
    pp.plan_from_config(smoke_cfg, 1.0)
    seen.append(pp.tf_cache_stats())
    pp.clear_tf_cache()
    seen.append(pp.tf_cache_stats())
    return seen


def test_tf_cache_stats_count_as_the_reference():
    got = _cache_sequence(tdf, tpp, CONFIGS["donn-mnist-3l"][1])
    want = _cache_sequence(jdf, jpp, jdonn.donn3()[1])
    assert got == want
    assert got[1] == {"hits": 2, "misses": 4}
    # the port's one-shot propagate builds its plane through the cache
    u = torch.from_numpy(_rand_field(32, 15))
    for _ in range(2):
        tdf.propagate(u, tdf.Grid(32, PX), 0.02, WL)
    assert tpp.tf_cache_stats() == {"hits": 1, "misses": 1}
    tpp.clear_tf_cache()


# ------------------------------------------- helpers, presets and registry
def test_fresnel_number_and_phase_to_field():
    assert tdf.fresnel_number(tdf.Grid(200, PX), 0.3, WL) \
        == jdf.fresnel_number(jdf.Grid(200, PX), 0.3, WL)
    phi = np.random.default_rng(16).uniform(-7, 7, (5, 9)).astype(np.float32)
    got = tdf.phase_to_field(torch.from_numpy(phi))
    assert got.dtype == torch.complex64
    _near_jax(got.numpy(), np.asarray(jdf.phase_to_field(jnp.asarray(phi))))


def test_detector_intensity_image():
    u = _rand_field(32, 17, lead=(3,))
    det = tlayers.Detector(tdf.Grid(32, PX), 4, 4, device="cpu")
    got = det.intensity_image(torch.from_numpy(u)).numpy()
    want = jlayers.Detector(jdf.Grid(32, PX), 4, 4).intensity_image(
        jnp.asarray(u))
    _near_jax(got, np.asarray(want))


@pytest.mark.parametrize("preset,kw", [
    ("slm", {}), ("slm", dict(levels=64, response_gamma=1.3, name="x")),
    ("printed_mask", {}), ("printed_mask", dict(levels=8)),
])
def test_device_presets(preset, kw):
    got, want = getattr(tcd, preset)(**kw), getattr(jcd, preset)(**kw)
    assert isinstance(got, tcd.DeviceSpec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(got.level_phases(), want.level_phases())


def test_segment_slices_of_a_uniform_plan():
    got = tpp.plan_from_config(CONFIGS["donn-mnist-5l"][1], 1.0)
    want = jpp.plan_from_config(jdonn.donn5()[1], 1.0)
    assert got.segment_slices == want.segment_slices == ((0, 5),)


def test_register_adds_a_factory_as_the_reference():
    name = "registered-in-a-test"
    pairs = {}
    try:
        for mod in (tmconfig, jmconfig):
            full = mod.get_config("qwen1.5-4b")
            smoke = mod.get_config("qwen1.5-4b", smoke=True)
            pairs[mod] = (full, smoke)

            @mod.register(name)
            def build(pair=(full, smoke)):
                return pair

            assert mod.get_config(name) is full
            assert mod.get_config(name, smoke=True) is smoke
            assert name in mod.list_archs()
        assert pairs[tmconfig][1].name == pairs[jmconfig][1].name
    finally:
        tmconfig._REGISTRY.pop(name, None)
        jmconfig._REGISTRY.pop(name, None)
    assert name not in tmconfig.list_archs()
    with pytest.raises(KeyError):
        tmconfig.get_config(name)


@pytest.mark.parametrize("fn,arch", [
    ("donn3", "donn-mnist-3l"), ("donn5", "donn-mnist-5l"),
    ("donn_chip", "donn-chip"), ("donn_rgb", "donn-rgb"),
    ("donn_seg", "donn-seg"), ("donn_xl", "donn-xl-500"),
])
def test_named_donn_config_functions(fn, arch):
    got, want = getattr(tdonn, fn)(), getattr(jdonn, fn)()
    assert got is CONFIGS[arch]
    for t, j in zip(got, want):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_donn_rules_are_the_reference_table():
    assert tsteps.DONN_RULES == jsteps.DONN_RULES


def test_hybrid_config_is_what_the_port_dsl_assembles():
    """HYBRID_SLM_PRINTED is the config the port's DSL builds for
    examples/advanced_donns.py's hybrid stack, as the reference's DSL
    builds it there, with the same two fused segments."""
    built = {}
    for dsl, kw in ((tdsl, {"device": "cpu"}), (jdsl, {})):
        front = [dsl.layers.diffractlayer(distance=0.10, pixel_size=36e-6,
                                          size=64, precision=256)
                 for _ in range(3)]
        back = [dsl.layers.diffractlayer(distance=0.05, pixel_size=48e-6,
                                         size=48, precision=4)
                for _ in range(2)]
        det = dsl.layers.detector(num_classes=10, det_size=8, distance=0.06)
        model, cfg = dsl.models.sequential(
            front + back, det, laser=dsl.laser(wavelength=532e-9),
            name="hybrid-slm-printed", **kw)
        assert model.plan.segment_slices == ((0, 3), (3, 5))
        built[dsl] = cfg
    assert built[tdsl] == HYBRID_SLM_PRINTED
    want = dataclasses.asdict(built[jdsl])
    assert dataclasses.asdict(HYBRID_SLM_PRINTED) == want
    assert isinstance(built[jdsl], jconfig.DONNConfig)
