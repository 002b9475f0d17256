"""The port's kernel wrappers (plain versions, CPU) against the JAX kernels.

``repro_torch.kernels.ops`` on CPU tensors runs the plain PyTorch version
of each hand-written Hopper kernel; the JAX side runs the Pallas kernels in
interpret mode, as the JAX package's own tests do off-TPU.  Inputs come
from a seeded numpy generator and feed both sides.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (f32).  Measured with the
CPU builds of torch 2.13 and jax 0.9: K2 agrees to <= 1.3e-7, the K1 hop
(two FFTs on each side) to <= 4.0e-7, K3 (sums in another order) to
<= 7.8e-7.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

RTOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _field(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _planes(rng, shape):
    theta = rng.uniform(-2 * np.pi, 2 * np.pi, shape).astype(np.float32)
    amp = rng.uniform(0.0, 1.5, shape).astype(np.float32)
    return theta, amp


def _jax_split(x):
    return jnp.asarray(x.real), jnp.asarray(x.imag)


def _jax_complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


# (field shape, plane shape): a shared (H, W) plane, plane stacks with
# nb > 1 (P=5; multi-axis (2, 3)), a bare plane stack, odd sizes
SHAPES = [
    ((4, 16, 16), (16, 16)),
    ((3, 5, 16, 24), (5, 16, 24)),
    ((2, 2, 3, 12, 12), (2, 3, 12, 12)),
    ((5, 16, 16), (5, 16, 16)),
    ((3, 37, 53), (37, 53)),
    ((2, 4, 37, 53), (4, 37, 53)),
]


@pytest.mark.parametrize("xshape,pshape", SHAPES)
def test_phase_tf_apply_matches_jax(xshape, pshape):
    rng = np.random.default_rng(0)
    x = _field(rng, xshape)
    theta, amp = _planes(rng, pshape)
    want = _jax_complex(jops.phase_tf_apply(
        *_jax_split(x), jnp.asarray(theta), jnp.asarray(amp)))
    got = kops.phase_tf_apply(torch.from_numpy(x), torch.from_numpy(theta),
                              torch.from_numpy(amp))
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("xshape,pshape", SHAPES)
def test_fused_spectral_hop_matches_jax(xshape, pshape):
    rng = np.random.default_rng(1)
    x = _field(rng, xshape)
    th_h, amp_h = _planes(rng, pshape)
    th_m, amp_m = _planes(rng, pshape)
    planes = (th_h, amp_h, th_m, amp_m)
    want = _jax_complex(jops.fused_spectral_hop(
        *_jax_split(x), *(jnp.asarray(p) for p in planes)))
    got = kops.fused_spectral_hop(torch.from_numpy(x),
                                  *(torch.from_numpy(p) for p in planes))
    assert _rel(got.numpy(), want) <= RTOL


def test_fused_spectral_hop_broadcasts_shared_tf_over_plane_stack():
    """TF planes (H, W) shared, modulation planes (C, H, W) per slot."""
    rng = np.random.default_rng(2)
    x = _field(rng, (2, 3, 16, 16))
    th_h, amp_h = _planes(rng, (16, 16))
    th_m, amp_m = _planes(rng, (3, 16, 16))
    planes = (th_h, amp_h, th_m, amp_m)
    want = _jax_complex(jops.fused_spectral_hop(
        *_jax_split(x), *(jnp.asarray(p) for p in planes)))
    got = kops.fused_spectral_hop(torch.from_numpy(x),
                                  *(torch.from_numpy(p) for p in planes))
    assert _rel(got.numpy(), want) <= RTOL


def test_fused_spectral_hop_is_the_textbook_hop():
    """M . ifft2(Hc . fft2(x)) — the conjugation identity holds in torch."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_field(rng, (3, 20, 20)))
    th_h, amp_h, th_m, amp_m = (torch.from_numpy(p) for p in
                                (*_planes(rng, (20, 20)),
                                 *_planes(rng, (20, 20))))
    hc = torch.polar(amp_h, th_h)
    m = torch.polar(amp_m, th_m)
    want = m * torch.fft.ifft2(hc * torch.fft.fft2(x))
    got = kops.fused_spectral_hop(x, th_h, amp_h, th_m, amp_m)
    assert _rel(got.numpy(), want.numpy()) <= RTOL


@pytest.mark.parametrize("ushape,C,binary", [
    ((4, 32, 32), 10, False),
    ((4, 32, 32), 10, True),
    ((3, 37, 53), 10, False),
    ((2, 3, 24, 24), 4, False),
    ((24, 24), 3, False),
])
def test_intensity_readout_matches_jax(ushape, C, binary):
    rng = np.random.default_rng(4)
    u = _field(rng, ushape)
    H, W = ushape[-2:]
    if binary:
        masks = (rng.random((C, H, W)) < 0.1).astype(np.float32)
    else:  # general masks, negative weights included
        masks = rng.uniform(-0.5, 1.0, (C, H, W)).astype(np.float32)
    want = np.asarray(jops.intensity_readout(*_jax_split(u),
                                             jnp.asarray(masks)))
    got = kops.intensity_readout(torch.from_numpy(u), torch.from_numpy(masks))
    assert got.shape == tuple(ushape[:-2]) + (C,)
    assert _rel(got.numpy(), want) <= RTOL


def test_conj_phase_scale_plain_version_matches_jax_kernel():
    """K1 alone (one pass of the hop) against the Pallas kernel."""
    from repro.kernels import spectral_hop as jsh

    rng = np.random.default_rng(5)
    P, nb, H, W = 3, 2, 16, 128  # Pallas blocks tile (8, 128) exactly
    x = _field(rng, (P * nb, H, W))
    theta, amp = _planes(rng, (P, H, W))
    for sign, scale in ((-1.0, 1.0), (1.0, 1.0 / (H * W))):
        want = _jax_complex(jsh.conj_phase_scale_pallas(
            *_jax_split(x), jnp.asarray(theta), jnp.asarray(amp),
            sign=sign, scale=scale, nb=nb, bh=8, bw=128, interpret=True))
        got = kref.conj_phase_scale_ref(torch.from_numpy(x),
                                        torch.from_numpy(theta),
                                        torch.from_numpy(amp), nb, sign, scale)
        assert _rel(got.numpy(), want) <= RTOL


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((2, 8, 8), dtype=torch.complex64)
    th = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="plane axes"):
        kops.phase_tf_apply(x, torch.zeros((3, 8, 8)), torch.zeros((3, 8, 8)))
    with pytest.raises(TypeError, match="complex64"):
        kops.phase_tf_apply(x.to(torch.complex128), th, th)
    with pytest.raises(TypeError, match="float32"):
        kops.phase_tf_apply(x, th.double(), th.double())
    with pytest.raises(ValueError, match="masks"):
        kops.intensity_readout(x, torch.zeros((3, 8, 9)))


def test_exported_signatures_read_the_c_prototypes():
    """ctypes argument types come from the sources' extern "C" prototypes."""
    P, I64, F32, INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
    launchers = {
        "spectral_hop": {"conj_phase_scale": (
            [P, P, P, P, I64, I64, I64, F32, F32, P, INT], INT)},
        "complex_mul": {"phase_tf_apply": (
            [P, P, P, P, I64, I64, I64, P, INT], INT)},
        "intensity_readout": {
            "intensity_readout": ([P, P, P, P, I64, I64, INT, P, INT], INT),
            "readout_tile_pixels": ([], INT)},
    }
    assert set(launchers) == set(kbuild.SOURCES)
    for name, want in launchers.items():
        got = kbuild.source_signatures(name)
        assert got["repro_error_string"] == ([INT], ctypes.c_char_p)
        assert {k: v for k, v in got.items() if k != "repro_error_string"} \
            == want, name
    with pytest.raises(RuntimeError, match="no ctypes mapping"):
        kbuild.exported_signatures('extern "C" int f(double x) { }')
    assert kbuild.exported_signatures(
        'extern "C"  const  char *g(void) {}') == {"g": ([], ctypes.c_char_p)}


class _CheckingLib:
    """Stands in for a loaded kernel library: checks each call's arguments
    against the signature read from the source, as ctypes would convert
    them, and launches nothing."""

    def __init__(self, name):
        self.sigs = kbuild.source_signatures(name)
        self.calls = []

    def __getattr__(self, fn):
        argtypes, _ = self.sigs[fn]

        def call(*args):
            assert len(args) == len(argtypes), (fn, len(args), len(argtypes))
            for t, a in zip(argtypes, args):
                t.from_param(a)  # TypeError on a value of the wrong type
            self.calls.append(fn)
            return 2048 if fn == "readout_tile_pixels" else 0
        return call


def test_card_wrappers_pass_the_launchers_their_c_arguments(monkeypatch):
    """The CUDA branch of each wrapper calls its launcher with exactly the
    arguments of the C prototype (run here with the launch stubbed out)."""
    libs = {}
    monkeypatch.setattr(kbuild, "library",
                        lambda name: libs.setdefault(name, _CheckingLib(name)))
    monkeypatch.setattr(kops, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(kops, "_stream", lambda dev: 0)
    x = torch.zeros((6, 9, 11), dtype=torch.complex64)
    th = torch.zeros((3, 9, 11))
    kops.reset_launch_counts()
    kops.conj_phase_scale(x, th, th, 2, -1.0, 1.0)
    kops.phase_tf_apply_planes(x, th, th, 2)
    kops.intensity_readout_rows(x, torch.zeros((4, 9, 11)))
    assert libs["spectral_hop"].calls == ["conj_phase_scale"]
    assert libs["complex_mul"].calls == ["phase_tf_apply"]
    assert libs["intensity_readout"].calls == ["readout_tile_pixels",
                                               "intensity_readout"]
    assert kops.launch_counts() == dict.fromkeys(kops.KERNELS, 1)
    kops.reset_launch_counts()


def test_cpu_path_launches_nothing():
    """Plain versions on the CPU never count as kernel launches."""
    kops.reset_launch_counts()
    x = torch.ones((2, 8, 8), dtype=torch.complex64)
    th = torch.zeros((8, 8))
    kops.fused_spectral_hop(x, th, th + 1, th, th + 1)
    kops.phase_tf_apply(x, th, th + 1)
    kops.intensity_readout(x, torch.ones((3, 8, 8)))
    assert kops.launch_counts() == dict.fromkeys(kops.KERNELS, 0)
