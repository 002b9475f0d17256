"""The port's kernel wrappers (plain versions, CPU) against the JAX kernels.

``repro_torch.kernels.ops`` on CPU tensors runs the plain PyTorch version
of each hand-written Hopper kernel; the JAX side runs the Pallas kernels in
interpret mode, as the JAX package's own tests do off-TPU.  Inputs come
from a seeded numpy generator and feed both sides.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (f32).  Measured with the
CPU builds of torch 2.13 and jax 0.9: K2 agrees to <= 1.3e-7, the K1 hop
(two FFTs on each side) to <= 4.0e-7, K3 (sums in another order) to
<= 7.8e-7, K5 to 5.4e-8, K6 to 9.3e-8 in f32 and to the bit in bf16
(both sides round after each bf16 product), K7 to 1.4e-7.

The VJP tests hold each autograd Function (on CPU tensors it runs the
plain versions through the same backward formulas that launch the
kernels on the card) against ``jax.vjp`` of the reference wrapper, for a
fixed real projection ``sum(w_r out_r + w_i out_i)`` of the output.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
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
        "complex_mul": {
            "phase_tf_apply": ([P, P, P, P, I64, I64, I64, P, INT], INT),
            "phase_apply": ([P, P, P, I64, I64, F32, P, INT], INT)},
        "intensity_readout": {
            "intensity_readout": ([P, P, P, P, I64, I64, INT, P, INT], INT),
            "readout_scratch_floats": ([I64, I64, INT], I64)},
        "rope": {
            "rope_f32": ([P, P, P, P, I64, I64, I64, P, INT], INT),
            "rope_bf16": ([P, P, P, P, I64, I64, I64, P, INT], INT)},
        "selective_scan": {
            "selective_scan": ([P, P, P, P, P, P, I64, I64, I64, I64, P, INT],
                               INT),
            "selective_scan_smem_bytes": ([I64], I64)},
    }
    launchers["complex_mul"]["complex_mul"] = ([P, P, P, I64, I64, P, INT],
                                               INT)
    launchers["transfer_planes"] = {"transfer_planes": (
        [P, P, P, I64, I64, I64, INT, INT, INT, P, INT], INT)}
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
            return 64 if fn == "readout_scratch_floats" else 0
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
    kops.phase_apply_rows(x, th[0], 1.12)
    kops.complex_mul_rows(x, x[0])
    for dtype in (torch.float32, torch.bfloat16):
        r = torch.zeros((4, 9, 12), dtype=dtype)
        kops.rope_rows(r, r[0, :, :6], r[0, :, :6])
    kops.selective_scan(torch.zeros((2, 5, 7)), torch.zeros((2, 5, 7)),
                        torch.zeros((2, 5, 3)), torch.zeros((2, 5, 3)),
                        torch.zeros((7, 3)))
    kops.transfer_planes_batched(torch.zeros((3, 5), dtype=torch.float64),
                                 9, "fresnel", True, False)
    assert libs["spectral_hop"].calls == ["conj_phase_scale"]
    assert libs["complex_mul"].calls == ["phase_tf_apply", "phase_apply",
                                         "complex_mul"]
    assert libs["intensity_readout"].calls == ["readout_scratch_floats",
                                               "intensity_readout"]
    assert libs["rope"].calls == ["rope_f32", "rope_bf16"]
    assert libs["selective_scan"].calls == ["selective_scan"]
    assert libs["transfer_planes"].calls == ["transfer_planes"]
    assert kops.launch_counts() == {**dict.fromkeys(kops.KERNELS, 1),
                                    "rope": 2}
    kops.reset_launch_counts()


def test_cpu_path_launches_nothing():
    """Plain versions on the CPU never count as kernel launches."""
    kops.reset_launch_counts()
    x = torch.ones((2, 8, 8), dtype=torch.complex64)
    th = torch.zeros((8, 8))
    kops.fused_spectral_hop(x, th, th + 1, th, th + 1)
    kops.phase_tf_apply(x, th, th + 1)
    kops.intensity_readout(x, torch.ones((3, 8, 8)))
    kops.phase_apply(x, th, 1.12)
    kops.complex_mul(x, x[0])
    kops.apply_rope(th[None], th[:, :4], th[:, :4])
    kops.selective_scan(th[None], th[None], th[None, :, :2], th[None, :, :2],
                        th[:, :2])
    kops.transfer_planes_batched(torch.full((2, 4), 1e-5, dtype=torch.float64),
                                 8, "rs", True, True)
    assert kops.launch_counts() == dict.fromkeys(kops.KERNELS, 0)


# ------------------------------------------------------------ K4
@pytest.mark.parametrize("ushape", [(4, 16, 16), (3, 37, 53), (16, 16),
                                    (2, 3, 12, 20)])
def test_phase_apply_matches_jax(ushape):
    rng = np.random.default_rng(6)
    u = _field(rng, ushape)
    phi = rng.uniform(-2 * np.pi, 2 * np.pi, ushape[-2:]).astype(np.float32)
    want = _jax_complex(jops.phase_apply(*_jax_split(u), jnp.asarray(phi),
                                         1.12))
    got = kops.phase_apply(torch.from_numpy(u), torch.from_numpy(phi), 1.12)
    assert got.shape == ushape
    assert _rel(got.numpy(), want) <= RTOL


def test_phase_apply_plain_version_matches_jax_kernel():
    """K4 alone against the Pallas kernel in interpret mode."""
    from repro.kernels import complex_mul as jcm

    rng = np.random.default_rng(7)
    u = _field(rng, (3, 16, 128))  # Pallas blocks tile (8, 128) exactly
    phi = rng.uniform(-7, 7, (16, 128)).astype(np.float32)
    want = _jax_complex(jcm.phase_apply_pallas(
        *_jax_split(u), jnp.asarray(phi), 1.12, bh=8, bw=128,
        interpret=True))
    got = kref.phase_apply_ref(torch.from_numpy(u), torch.from_numpy(phi),
                               1.12)
    assert _rel(got.numpy(), want) <= RTOL


def test_phase_apply_rejects_bad_inputs():
    u = torch.zeros((2, 8, 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match="one \\(H, W\\) plane"):
        kops.phase_apply(u, torch.zeros((2, 8, 8)), 1.0)
    with pytest.raises(TypeError, match="float32"):
        kops.phase_apply(u, torch.zeros((8, 8), dtype=torch.float64), 1.0)


# ------------------------------------------------------------ VJPs
def _projection(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port_vjp(fn, x, planes, w):
    """Gradients of sum(w_r out_r + w_i out_i) w.r.t. x and the planes."""
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = [torch.from_numpy(p).requires_grad_(True) for p in planes]
    out = fn(xt, *pt)
    loss = (torch.from_numpy(w[0]) * out.real
            + torch.from_numpy(w[1]) * out.imag).sum()
    return torch.autograd.grad(loss, [xt] + pt, allow_unused=True)


def _jax_vjp(fn, x, planes, w):
    out, vjp = jax.vjp(fn, *_jax_split(x), *(jnp.asarray(p) for p in planes))
    grads = vjp((jnp.asarray(w[0]), jnp.asarray(w[1])))
    return [_jax_complex(grads[:2])] + [np.asarray(g) for g in grads[2:]]


# a shared (H, W) plane and a P=3 plane stack with nb=2
VJP_SHAPES = [((4, 16, 16), (16, 16)), ((2, 3, 20, 24), (3, 20, 24))]


@pytest.mark.parametrize("xshape,pshape", VJP_SHAPES)
def test_phase_tf_apply_vjp_matches_jax(xshape, pshape):
    rng = np.random.default_rng(8)
    x = _field(rng, xshape)
    theta, amp = _planes(rng, pshape)
    w = _projection(rng, xshape)
    got = _port_vjp(kops.phase_tf_apply, x, (theta, amp), w)
    want = _jax_vjp(jops.phase_tf_apply, x, (theta, amp), w)
    assert _rel(got[0].numpy(), want[0]) <= RTOL  # dx
    assert _rel(got[1].numpy(), want[1]) <= RTOL  # d theta
    assert got[2] is None and not np.any(want[2])  # d amp = 0


@pytest.mark.parametrize("xshape,pshape", VJP_SHAPES)
def test_fused_spectral_hop_vjp_matches_jax(xshape, pshape):
    rng = np.random.default_rng(9)
    x = _field(rng, xshape)
    planes = (*_planes(rng, pshape), *_planes(rng, pshape))
    w = _projection(rng, xshape)
    got = _port_vjp(kops.fused_spectral_hop, x, planes, w)
    want = _jax_vjp(jops.fused_spectral_hop, x, planes, w)
    assert _rel(got[0].numpy(), want[0]) <= RTOL  # dx
    assert _rel(got[3].numpy(), want[3]) <= RTOL  # d theta_m
    for i in (1, 2, 4):  # TF planes and amp_m: static geometry
        assert got[i] is None and not np.any(want[i])


def test_fused_spectral_hop_vjp_folds_a_broadcast_plane():
    """TF planes (H, W) shared, phases (3, H, W): d theta_m per slot."""
    rng = np.random.default_rng(10)
    x = _field(rng, (2, 3, 16, 16))
    th_h, amp_h = _planes(rng, (16, 16))
    th_m, amp_m = _planes(rng, (3, 16, 16))
    planes = (th_h, amp_h, th_m, amp_m)
    w = _projection(rng, x.shape)
    got = _port_vjp(kops.fused_spectral_hop, x, planes, w)
    want = _jax_vjp(jops.fused_spectral_hop, x, planes, w)
    assert got[3].shape == (3, 16, 16)
    assert _rel(got[0].numpy(), want[0]) <= RTOL
    assert _rel(got[3].numpy(), want[3]) <= RTOL


@pytest.mark.parametrize("ushape", [(4, 24, 24), (2, 3, 16, 20)])
def test_intensity_readout_vjp_matches_jax(ushape):
    rng = np.random.default_rng(11)
    u = _field(rng, ushape)
    masks = rng.uniform(-0.5, 1.0, (5,) + ushape[-2:]).astype(np.float32)
    g = rng.standard_normal(ushape[:-2] + (5,)).astype(np.float32)
    ut = torch.from_numpy(u).requires_grad_(True)
    (du,) = torch.autograd.grad(
        (kops.intensity_readout(ut, torch.from_numpy(masks))
         * torch.from_numpy(g)).sum(), ut)
    _, vjp = jax.vjp(lambda a, b: jops.intensity_readout(a, b,
                                                         jnp.asarray(masks)),
                     *_jax_split(u))
    want = _jax_complex(vjp(jnp.asarray(g)))
    assert _rel(du.numpy(), want) <= RTOL


@pytest.mark.parametrize("ushape", [(4, 16, 16), (2, 3, 12, 20), (16, 16)])
def test_phase_apply_vjp_matches_jax(ushape):
    rng = np.random.default_rng(12)
    u = _field(rng, ushape)
    phi = rng.uniform(-7, 7, ushape[-2:]).astype(np.float32)
    w = _projection(rng, ushape)
    got = _port_vjp(lambda a, p: kops.phase_apply(a, p, 1.12), u, (phi,), w)
    want = _jax_vjp(lambda a, b, p: jops.phase_apply(a, b, p, 1.12), u,
                    (phi,), w)
    assert _rel(got[0].numpy(), want[0]) <= RTOL  # du
    assert _rel(got[1].numpy(), want[1]) <= RTOL  # d phi


def test_backward_skips_input_gradients_nobody_needs():
    """Layer 0's input needs no grad: its backward computes only d theta
    (the reference's jit drops that work the same way)."""
    calls = []
    real = kops.phase_tf_apply_planes

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    x = torch.ones((2, 8, 8), dtype=torch.complex64)
    th = torch.zeros((8, 8), requires_grad=True)
    amp = torch.ones((8, 8))
    try:
        kops.phase_tf_apply_planes = counting
        out = kops.fused_spectral_hop(x, th.detach(), amp, th, amp)
        (g,) = torch.autograd.grad(out.real.sum(), th)
        assert calls == [] and g.shape == (8, 8)
        out = kops.fused_spectral_hop(x.requires_grad_(True), th.detach(),
                                      amp, th, amp)
        torch.autograd.grad(out.real.sum(), [x, th])
        assert len(calls) == 2  # K2 twice for dx
    finally:
        kops.phase_tf_apply_planes = real



# ------------------------------------------------------------ K5-K7
@pytest.mark.parametrize("ashape", [(4, 16, 16), (3, 37, 53), (37, 53)])
def test_complex_mul_matches_jax(ashape):
    """K5 on complex64 tensors against the reference's split planes; a 2-D
    ``a`` is one field (the reference's squeeze)."""
    rng = np.random.default_rng(20)
    a = _field(rng, ashape)
    b = _field(rng, ashape[-2:])
    want = _jax_complex(jops.complex_mul(*_jax_split(a), *_jax_split(b)))
    got = kops.complex_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == ashape
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("ashape", [(4, 16, 20), (16, 20)])
def test_complex_mul_vjp_matches_jax(ashape):
    """da = g conj(b), db = sum_B g conj(a), against ``jax.vjp`` of the
    reference wrapper; PyTorch's complex gradient of a real projection is
    the reference's split-plane cotangent."""
    rng = np.random.default_rng(21)
    a, g = _field(rng, ashape), _field(rng, ashape)
    b = _field(rng, ashape[-2:])
    _, vjp = jax.vjp(jops.complex_mul, *_jax_split(a), *_jax_split(b))
    dar, dai, dbr, dbi = vjp(_jax_split(g))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = kops.complex_mul(at, bt)
    gt = torch.from_numpy(g)
    loss = (gt.real * out.real + gt.imag * out.imag).sum()
    da, db = torch.autograd.grad(loss, [at, bt])
    assert _rel(da.numpy(), _jax_complex((dar, dai))) <= RTOL
    assert _rel(db.numpy(), _jax_complex((dbr, dbi))) <= RTOL


def _rope_case(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    ang = rng.uniform(0.0, 60.0, (shape[-2], shape[-1] // 2))
    cos, sin = (f(ang).astype(np.float32) for f in (np.cos, np.sin))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(v, jd) for v in (x, cos, sin)],
            [torch.from_numpy(v).to(td) for v in (x, cos, sin)])


@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 37, 64), "float32"),  # S not a multiple of the 8-row block
    ((5, 13, 32), "float32"),
    ((2, 3, 37, 64), "bfloat16"),
])
def test_apply_rope_matches_jax(shape, dtype):
    """K6's plain version against the Pallas kernel (interpret mode): f32
    within RTOL, bf16 to the bit (both round after each bf16 product)."""
    jargs, targs = _rope_case(np.random.default_rng(22), shape, dtype)
    want = np.asarray(jops.apply_rope(*jargs).astype(jnp.float32))
    got = kops.apply_rope(*targs)
    assert got.dtype == targs[0].dtype and got.shape == shape
    tol = RTOL if dtype == "float32" else 0.0
    assert _rel(got.float().numpy(), want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_vjp_matches_jax(dtype):
    """dx = K6(g, cos, -sin) against ``jax.vjp`` of ``ops.apply_rope``."""
    rng = np.random.default_rng(23)
    jargs, targs = _rope_case(rng, (2, 3, 21, 32), dtype)
    g = rng.standard_normal((2, 3, 21, 32)).astype(np.float32)
    _, vjp = jax.vjp(jops.apply_rope, *jargs)
    want = np.asarray(vjp(jnp.asarray(g, jargs[0].dtype))[0].astype(
        jnp.float32))
    x = targs[0].clone().requires_grad_(True)
    out = kops.apply_rope(x, *targs[1:])
    (dx,) = torch.autograd.grad(out, [x], torch.from_numpy(g).to(x.dtype))
    tol = RTOL if dtype == "float32" else 0.0
    assert _rel(dx.float().numpy(), want) <= tol


@pytest.mark.parametrize("B,S,D,N", [(2, 37, 200, 16), (1, 9, 10, 4)])
def test_selective_scan_matches_jax(B, S, D, N):
    """K7's plain version against the Pallas kernel (interpret mode; D not
    a multiple of its 128-lane block) and the reference's oracle."""
    rng = np.random.default_rng(24)
    dt = (0.2 * np.log1p(np.exp(rng.standard_normal((B, S, D))))).astype(
        np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    bs = rng.standard_normal((B, S, N)).astype(np.float32)
    cs = rng.standard_normal((B, S, N)).astype(np.float32)
    a = -np.exp(rng.standard_normal((D, N))).astype(np.float32)
    args = (dt, x, bs, cs, a)
    got = kops.selective_scan(*(torch.from_numpy(v) for v in args))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    for oracle in (jops.selective_scan, jops.selective_scan_ref):
        want = np.asarray(oracle(*(jnp.asarray(v) for v in args)))
        assert _rel(got.numpy(), want) <= RTOL, oracle.__name__
    ref_y = kops.selective_scan_ref(*(torch.from_numpy(v) for v in args))
    assert torch.equal(got, ref_y)


def test_k5_to_k7_wrappers_reject_bad_inputs():
    a = torch.zeros((2, 8, 8), dtype=torch.complex64)
    with pytest.raises(TypeError, match="complex64"):
        kops.complex_mul(a, torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="plane"):
        kops.complex_mul(a, a)
    x = torch.zeros((2, 5, 8))
    with pytest.raises(TypeError, match="share"):
        kops.apply_rope(x, torch.zeros((5, 4), dtype=torch.bfloat16),
                        torch.zeros((5, 4), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="cos/sin"):
        kops.apply_rope(x, torch.zeros((5, 8)), torch.zeros((5, 8)))
    with pytest.raises(ValueError, match="selective_scan"):
        kops.selective_scan(x, x, x[..., :2], x[..., :2], torch.zeros((8, 3)))
