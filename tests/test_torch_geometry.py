"""The port's static geometry, encoders and codesign against the JAX package.

Geometry built with numpy (transfer planes, detector masks, laser fields)
must be bit-equal; the config dataclasses and the physics validator must
be the same objects field by field and criterion by criterion; the torch
encoders and the deploy-time codesign must match the reference's values.
Inputs come from seeded numpy generators and feed both sides.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import donn as jcfgs  # noqa: E402
from repro.core import codesign as jcd  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import diffraction as jdf  # noqa: E402
from repro.core import laser as jlaser  # noqa: E402
from repro.core import layers as jlayers  # noqa: E402
from repro.core import physics as jphys  # noqa: E402
from repro.core import propagation as jpp  # noqa: E402
from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.core import codesign as tcd  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import diffraction as tdf  # noqa: E402
from repro_torch.core import laser as tlaser  # noqa: E402
from repro_torch.core import layers as tlayers  # noqa: E402
from repro_torch.core import physics as tphys  # noqa: E402
from repro_torch.core import propagation as tpp  # noqa: E402
from repro_torch.core.models import config_static_key  # noqa: E402


def _jcfg(tcfg):
    """The reference's DONNConfig with the port config's field values."""
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    if kw["layers"] is not None:
        kw["layers"] = tuple(jconfig.LayerSpec(**dataclasses.asdict(l))
                             for l in kw["layers"])
    return jconfig.DONNConfig(**kw)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("cls", ["DONNConfig", "LayerSpec"])
def test_dataclass_fields_equal_reference(cls):
    tf = dataclasses.fields(getattr(tconfig, cls))
    jf = dataclasses.fields(getattr(jconfig, cls))
    assert [(f.name, f.type, f.default) for f in tf] == \
        [(f.name, f.type, f.default) for f in jf]


def test_registered_configs_equal_reference():
    ref = {}
    for fn in (jcfgs.donn3, jcfgs.donn5, jcfgs.donn_chip, jcfgs.donn_rgb,
               jcfgs.donn_seg, jcfgs.donn_xl):
        full, smoke = fn()
        ref[full.name] = (full, smoke)
    assert set(CONFIGS) == set(ref)
    for name, pair in CONFIGS.items():
        for t, j in zip(pair, ref[name]):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_canonical_and_static_key_match_reference():
    from repro.core.models import config_static_key as jkey

    cfg = tconfig.DONNConfig(
        name="k", n=32, depth=2,
        layers=(tconfig.LayerSpec(0.05), tconfig.LayerSpec(0.07)))
    assert cfg.canonical().layers is None
    assert config_static_key(cfg) == jkey(_jcfg(cfg))
    assert tpp.plan_cache_key(cfg, 1.0) == jpp.plan_cache_key(_jcfg(cfg), 1.0)


# ----------------------------------------------------------------- physics
@pytest.mark.parametrize("kw", [
    dict(n=64, distance=0.05),
    dict(n=1),
    dict(pixel_size=0.0),
    dict(n=32, band_limit=False, distance=5.0),  # sampling-aliasing
    dict(codesign="qat", device_levels=1),  # device-levels
    dict(approximation="fraunhofer", distance=0.0),  # geometry
    dict(approximation="fraunhofer", n=200, distance=0.05),  # far-field warn
    dict(approximation="fresnel", distance=1e-4),  # near-field warn
    dict(n=200, pixel_size=36e-6, distance=50.0),  # band-limit collapse
    dict(n=32, depth=2, layers=(tconfig.LayerSpec(0.05, size=40),
                                tconfig.LayerSpec(0.05, pixel_size=36e-6 * 5))),
])
def test_validator_fires_the_same_criteria(kw):
    cfg = tconfig.DONNConfig(**kw)
    jcfg = _jcfg(cfg)
    got = [(v.criterion, v.severity, v.where, v.message)
           for v in tphys.validate_config(cfg)]
    want = [(v.criterion, v.severity, v.where, v.message)
            for v in jphys.validate_config(jcfg)]
    assert got == want
    errors = [v for v in want if v[1] == jphys.ERROR]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if errors:
            with pytest.raises(tphys.PhysicsValidationError) as ei:
                tphys.check_config(cfg)
            assert sorted({v.criterion for v in ei.value.violations}) == \
                sorted({v[0] for v in errors})
        else:
            tphys.check_config(cfg)


def test_plan_from_config_validates():
    cfg = tconfig.DONNConfig(name="bad", n=32, band_limit=False, distance=5.0)
    with pytest.raises(tphys.PhysicsValidationError, match="sampling-aliasing"):
        tpp.plan_from_config(cfg, 1.0)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("method,band_limit,pad", [
    ("rs", True, False), ("rs", False, False), ("rs", True, True),
    ("fresnel", True, False), ("fresnel", False, True),
    ("fraunhofer", True, False),
])
def test_transfer_planes_bit_equal(method, band_limit, pad):
    grid_t, grid_j = tdf.Grid(48, 36e-6), jdf.Grid(48, 36e-6)
    z = 0.3 if method != "fraunhofer" else 2.0
    got = tpp.transfer_planes(grid_t, z, 532e-9, method, band_limit, pad)
    want = jpp.transfer_planes(grid_j, z, 532e-9, method, band_limit, pad)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n,C,det,layout", [
    (200, 10, 20, "grid"), (64, 10, 8, "grid"), (64, 6, 8, "grid"),
    (96, 12, 6, "ring"),
])
def test_detector_masks_bit_equal(n, C, det, layout):
    t = tlayers.Detector(tdf.Grid(n, 36e-6), C, det, layout, device="cpu")
    j = jlayers.Detector(jdf.Grid(n, 36e-6), C, det, layout)
    assert t.coords == j.coords
    np.testing.assert_array_equal(t.masks, j.masks)
    np.testing.assert_array_equal(t.masks_t.numpy(), j.masks)


@pytest.mark.parametrize("profile", ["plane", "gaussian", "bessel"])
def test_laser_field_bit_equal(profile):
    t = tlaser.Laser(profile=profile, power=2.0).field(tdf.Grid(40, 36e-6))
    j = jlaser.Laser(profile=profile, power=2.0).field(jdf.Grid(40, 36e-6))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("shape,n,mode", [
    ((3, 28, 28), 64, "upsample"), ((2, 28, 28), 200, "upsample"),
    ((28, 28), 40, "embed"), ((2, 28, 28), 28, "upsample"),
])
def test_encoders_equal_reference(shape, n, mode):
    x = np.random.default_rng(0).random(shape, np.float32)
    got = tlaser.resize_to_grid(torch.from_numpy(x), n, mode).numpy()
    want = np.asarray(jlaser.resize_to_grid(jnp.asarray(x), n, mode))
    np.testing.assert_array_equal(got, want)
    got = tlaser.data_to_cplex(torch.from_numpy(x), n).numpy()
    want = np.asarray(jlaser.data_to_cplex(jnp.asarray(x), n))
    np.testing.assert_array_equal(got, want)
    got = tlaser.data_to_real(torch.from_numpy(x), n).numpy()
    want = np.asarray(jlaser.data_to_real(jnp.asarray(x), n))
    np.testing.assert_array_equal(got, want)


def test_pad_crop_and_intensity_equal_reference():
    rng = np.random.default_rng(1)
    u = (rng.standard_normal((2, 9, 9))
         + 1j * rng.standard_normal((2, 9, 9))).astype(np.complex64)
    pt = tdf.pad_field(torch.from_numpy(u), 9)
    np.testing.assert_array_equal(pt.numpy(),
                                  np.asarray(jdf.pad_field(jnp.asarray(u), 9)))
    np.testing.assert_array_equal(tdf.crop_field(pt, 9).numpy(), u)
    np.testing.assert_array_equal(
        tdf.intensity(torch.from_numpy(u)).numpy(),
        np.asarray(jdf.intensity(jnp.asarray(u))))


# ---------------------------------------------------------------- codesign
def _phases(seed=0, shape=(3, 24, 24)):
    # include negative phases and phases past 2 pi: wrap_phase must floor
    return np.random.default_rng(seed).uniform(
        -3 * np.pi, 5 * np.pi, shape).astype(np.float32)


@pytest.mark.parametrize("mode,levels,gamma,rtol", [
    ("qat", 256, 1.0, 0.0),  # rounding path: bit-equal
    ("qat", 256, 1.2, 0.0),  # argmin over device levels: bit-equal
    ("qat", 4, 1.0, 0.0),
    ("ptq", 16, 1.0, 0.0),
    ("ptq", 16, 1.3, 0.0),
    ("gumbel", 16, 1.0, 1e-5),  # softmax relaxation: exp/sum order differ
    ("gumbel_hard", 16, 1.2, 1e-5),
    ("none", 256, 1.0, 0.0),
])
def test_deployed_phase_matches_reference(mode, levels, gamma, rtol):
    phi = _phases()
    tdev = tcd.device_for_layer(mode, levels, gamma)
    jdev = jcd.device_for_layer(mode, levels, gamma)
    got = tcd.deployed_phase(torch.from_numpy(phi), tdev, mode).numpy()
    want = np.asarray(jcd.deployed_phase(jnp.asarray(phi), jdev, mode))
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


def test_wrap_phase_is_floored_modulo():
    phi = torch.tensor([-0.5, -7.0, 0.0, 6.5, 13.0])
    got = tcd.wrap_phase(phi).numpy()
    want = np.asarray(jcd.wrap_phase(jnp.asarray(phi.numpy())))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()


def test_weight_fab_indices_match_reference():
    phi = _phases(1)
    dev = tcd.DeviceSpec(levels=8, response_gamma=1.1)
    idx, ach = tcd.weight_fab(torch.from_numpy(phi), dev)
    jidx, jach = jcd.weight_fab(jnp.asarray(phi),
                                jcd.DeviceSpec(levels=8, response_gamma=1.1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ach.numpy(), np.asarray(jach))


def test_rng_codesign_is_refused():
    dev = tcd.DeviceSpec(levels=4)
    with pytest.raises(NotImplementedError, match="training slice"):
        tcd.apply_codesign(torch.zeros(4), dev, "gumbel", rng=object())
