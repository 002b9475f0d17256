"""Wrappers around the port's hand-written Hopper kernels (K1-K7, and
``transfer_planes_batched``, which builds a candidate set's transfer
planes and has no Pallas counterpart).

The public functions keep the JAX package's plane-stack contract
(``repro.kernels.ops``): ``theta``/``amp`` are one (H, W) plane shared by
every field, or a stack (*P, H, W) with x: (..., *P, H, W) so plane p
transforms the fields in slot p.  Fields are complex64 tensors; the
kernels read and write them interleaved (``torch.view_as_real`` layout,
what cuFFT returns), so no split into real/imag planes is needed.

Dispatch is by the tensor's device, never by a try: on a CUDA tensor the
wrapper launches its kernel (building it at first use) or raises; on a CPU
tensor it runs the plain PyTorch version in ``ref``, which exists for the
tests.  Planes in bf16 storage are upcast to f32 by the callers before
they get here.  K5 (``complex_mul``), K6 (``apply_rope``) and K7
(``selective_scan``) keep the shapes of the reference's public wrappers:
complex64 fields for K5 (the reference's split planes interleaved), x's
dtype (f32 or bf16) for K6, float32 for K7.

Gradients: each public function runs through a ``torch.autograd.Function``
with the reference's custom VJP (``_PhaseTFApply``, ``_FusedHop``,
``_Readout``, ``_PhaseApply``, ``_ComplexMul``, ``_Rope``;
``channel_intensity_readout`` is K3 then a channel sum); K7 is forward
only, as in the reference.  Their forward and backward dispatch by
device like the raw wrappers, so on the card the backward launches the
kernels (K2 for the TF multiply and the hop, K4 for the eager
modulation) and on the CPU it runs the same formulas on the plain
versions.  PyTorch's gradient of a real loss with respect to a complex
tensor is dL/dRe + j dL/dIm, the reference's split-plane cotangent
(g_r, g_i), so the formulas carry over unchanged.  The raw wrappers
(``conj_phase_scale``, ``phase_tf_apply_planes``,
``intensity_readout_rows``, ``phase_apply_rows``, ``complex_mul_rows``,
``rope_rows``), ``selective_scan`` and ``transfer_planes_batched``
record no gradient: on the card they raise when grad mode is on and an
input requires grad.

Every launch adds one to ``LAUNCHES[name]`` — the count that shows a run
really went through the kernels (``reset_launch_counts`` /
``launch_counts``).
"""
from __future__ import annotations

import math
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import build, ref

KERNELS = ("conj_phase_scale", "phase_tf_apply", "intensity_readout",
           "phase_apply", "complex_mul", "rope", "selective_scan",
           "transfer_planes")
LAUNCHES = {k: 0 for k in KERNELS}
_COUNT_LOCK = threading.Lock()  # the serving worker thread launches too


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _on_card(name: str, *tensors) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU ones.  A
    fake tensor (a dry-run's trace) raises: neither the kernel nor its
    plain version may stand in for the other in a count."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError(
            f"{name}: a fake tensor reached a hand-written kernel's wrapper; "
            "the dry-run traces configs with use_pallas=False")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a raw kernel call records no gradient and an input "
            "requires grad; call the public wrapper (its autograd Function)"
        )
    return True


def _dense(t: torch.Tensor) -> torch.Tensor:
    """The memory a kernel reads: no lazy conjugate/negative bit, dense."""
    return t.resolve_conj().resolve_neg().contiguous()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_stack(name: str, x, theta, amp, nb: int):
    if x.dtype != torch.complex64:
        raise TypeError(f"{name}: field must be complex64, got {x.dtype}")
    for p in (theta, amp):
        if p.dtype != torch.float32:
            raise TypeError(f"{name}: planes must be float32, got {p.dtype}")
    P, H, W = theta.shape
    if amp.shape != theta.shape or x.shape != (P * nb, H, W):
        raise ValueError(
            f"{name}: field {tuple(x.shape)} vs planes {tuple(theta.shape)}/"
            f"{tuple(amp.shape)} with nb={nb}"
        )


# --------------------------------------------------------------------------
# plane-major kernels: x (P*nb, H, W) complex64, theta/amp (P, H, W) f32
# --------------------------------------------------------------------------
def conj_phase_scale(x, theta, amp, nb: int, sign: float, scale: float):
    """K1: conj(x) * amp * scale * exp(sign * j * theta), plane-major."""
    _check_stack("conj_phase_scale", x, theta, amp, nb)
    if not _on_card("conj_phase_scale", x, theta, amp):
        return ref.conj_phase_scale_ref(x, theta, amp, nb, sign, scale)
    x, theta, amp = _dense(x), _dense(theta), _dense(amp)
    out = torch.empty_like(x)
    lib = build.library("spectral_hop")
    build.check(lib, lib.conj_phase_scale(
        x.data_ptr(), theta.data_ptr(), amp.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1] * x.shape[2], nb, float(scale),
        float(sign * scale), _stream(x.device), x.get_device(),
    ), "conj_phase_scale")
    _count("conj_phase_scale")
    return out


def phase_tf_apply_planes(x, theta, amp, nb: int):
    """K2: x * amp * exp(j theta), plane-major."""
    _check_stack("phase_tf_apply", x, theta, amp, nb)
    if not _on_card("phase_tf_apply", x, theta, amp):
        return ref.phase_tf_apply_ref(x, theta, amp, nb)
    x, theta, amp = _dense(x), _dense(theta), _dense(amp)
    out = torch.empty_like(x)
    lib = build.library("complex_mul")
    build.check(lib, lib.phase_tf_apply(
        x.data_ptr(), theta.data_ptr(), amp.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1] * x.shape[2], nb, _stream(x.device),
        x.get_device(),
    ), "phase_tf_apply")
    _count("phase_tf_apply")
    return out


def intensity_readout_rows(u, masks):
    """K3: (B, H, W) complex64 fields x (C, H, W) f32 masks -> (B, C) f32."""
    if u.dtype != torch.complex64 or masks.dtype != torch.float32:
        raise TypeError(
            f"intensity_readout: needs complex64 fields and float32 masks, "
            f"got {u.dtype} and {masks.dtype}"
        )
    if u.dim() != 3 or masks.dim() != 3 or u.shape[1:] != masks.shape[1:]:
        raise ValueError(
            f"intensity_readout: fields {tuple(u.shape)} vs masks "
            f"{tuple(masks.shape)}"
        )
    if not _on_card("intensity_readout", u, masks):
        return ref.intensity_readout_ref(u, masks)
    u, masks = _dense(u), _dense(masks)
    B, H, W = u.shape
    C = masks.shape[0]
    lib = build.library("intensity_readout")
    partial = torch.empty(lib.readout_scratch_floats(B, H * W, C),
                          dtype=torch.float32, device=u.device)
    out = torch.empty((B, C), dtype=torch.float32, device=u.device)
    build.check(lib, lib.intensity_readout(
        u.data_ptr(), masks.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, H * W, C, _stream(u.device), u.get_device(),
    ), "intensity_readout")
    _count("intensity_readout")
    return out


def phase_apply_rows(u, phi, gamma: float):
    """K4: gamma * u * exp(j phi); (B, H, W) complex64 fields, one (H, W)
    f32 phase plane shared by every field, gamma a host float."""
    if u.dtype != torch.complex64 or phi.dtype != torch.float32:
        raise TypeError(
            f"phase_apply: needs complex64 fields and a float32 phase, got "
            f"{u.dtype} and {phi.dtype}"
        )
    if u.dim() != 3 or phi.dim() != 2 or u.shape[1:] != phi.shape:
        raise ValueError(
            f"phase_apply: fields {tuple(u.shape)} vs phase "
            f"{tuple(phi.shape)}"
        )
    if not _on_card("phase_apply", u, phi):
        return ref.phase_apply_ref(u, phi, gamma)
    u, phi = _dense(u), _dense(phi)
    out = torch.empty_like(u)
    lib = build.library("complex_mul")
    build.check(lib, lib.phase_apply(
        u.data_ptr(), phi.data_ptr(), out.data_ptr(), u.shape[0],
        u.shape[1] * u.shape[2], float(gamma), _stream(u.device),
        u.get_device(),
    ), "phase_apply")
    _count("phase_apply")
    return out


def complex_mul_rows(a, b):
    """K5: a * b; (B, H, W) complex64 fields, one (H, W) complex64 plane."""
    if a.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise TypeError(f"complex_mul: needs complex64, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != 3 or b.dim() != 2 or a.shape[1:] != b.shape:
        raise ValueError(f"complex_mul: fields {tuple(a.shape)} vs plane "
                         f"{tuple(b.shape)}")
    if not _on_card("complex_mul", a, b):
        return ref.complex_mul_ref(a, b)
    a, b = _dense(a), _dense(b)
    out = torch.empty_like(a)
    lib = build.library("complex_mul")
    build.check(lib, lib.complex_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
        a.shape[1] * a.shape[2], _stream(a.device), a.get_device(),
    ), "complex_mul")
    _count("complex_mul")
    return out


_ROPE_LAUNCHERS = {torch.float32: "rope_f32", torch.bfloat16: "rope_bf16"}


def rope_rows(x, cos, sin):
    """K6: rotate-half RoPE; x (BN, S, D), cos/sin (S, D//2), one dtype
    (float32 or bfloat16)."""
    if x.dtype not in _ROPE_LAUNCHERS or cos.dtype != x.dtype \
            or sin.dtype != x.dtype:
        raise TypeError(
            f"rope: x, cos and sin must share float32 or bfloat16, got "
            f"{x.dtype}, {cos.dtype}, {sin.dtype}"
        )
    if x.dim() != 3 or x.shape[-1] % 2 or cos.shape != sin.shape \
            or tuple(cos.shape) != (x.shape[1], x.shape[2] // 2):
        raise ValueError(f"rope: x {tuple(x.shape)} vs cos/sin "
                         f"{tuple(cos.shape)}/{tuple(sin.shape)}")
    if not _on_card("rope", x, cos, sin):
        return ref.rope_ref(x, cos, sin)
    x, cos, sin = _dense(x), _dense(cos), _dense(sin)
    out = torch.empty_like(x)
    BN, S, D = x.shape
    lib = build.library("rope")
    launch = getattr(lib, _ROPE_LAUNCHERS[x.dtype])
    build.check(lib, launch(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        BN * S, S, D // 2, _stream(x.device), x.get_device(),
    ), "rope")
    _count("rope")
    return out


def selective_scan(dt, x, bs, cs, a):
    """K7: the mamba-1 scan forward from h = 0 (``ops.selective_scan``).

    dt/x (B, S, D); bs/cs (B, S, N); a (D, N) -> y (B, S, D) float32.
    Inputs are taken as float32, as the reference's wrapper casts them.
    Forward only: on the card it raises when grad mode is on and an input
    requires grad.  D needs no padding (the kernel masks its edge); N is at
    most 32 on the card.
    """
    B, S, D = x.shape
    N = bs.shape[-1]
    if dt.shape != x.shape or bs.shape != (B, S, N) or cs.shape != bs.shape \
            or a.shape != (D, N):
        raise ValueError(
            f"selective_scan: dt {tuple(dt.shape)}, x {tuple(x.shape)}, bs "
            f"{tuple(bs.shape)}, cs {tuple(cs.shape)}, a {tuple(a.shape)}"
        )
    if not _on_card("selective_scan", dt, x, bs, cs, a):
        return ref.selective_scan_ref(dt, x, bs, cs, a)
    if N > 32 or B > 65535:
        raise ValueError(f"selective_scan: the kernel takes N <= 32 and "
                         f"B <= 65535, got N={N}, B={B}")
    dt, x, bs, cs, a = (_dense(t.float()) for t in (dt, x, bs, cs, a))
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    lib = build.library("selective_scan")
    build.check(lib, lib.selective_scan(
        dt.data_ptr(), x.data_ptr(), bs.data_ptr(), cs.data_ptr(),
        a.data_ptr(), y.data_ptr(), B, S, D, N, _stream(x.device),
        x.get_device(),
    ), "selective_scan")
    _count("selective_scan")
    return y


def transfer_planes_batched(geometry, n: int, method: str, band_limit: bool,
                            polar: bool):
    """A candidate set's transfer planes, every candidate and gap at once.

    geometry: (K, 2 + G) float64, each row a candidate's pixel size,
    wavelength and G propagation distances [m]; n: the plane size (twice
    the field's under ``pad``); method ``"rs"`` or ``"fresnel"``.  Returns
    two (G*K, n, n) float32 planes, gap-major (row g*K + k is candidate
    k's gap g): (arg H, |H|) when ``polar``, (Re H, Im H) otherwise, as
    ``diffraction.transfer_function`` gives H with the phase in f64.  One
    launch on the card; no part of a plane passes through the host.
    """
    if geometry.dtype != torch.float64 or geometry.dim() != 2 \
            or geometry.shape[1] < 3:
        raise ValueError(
            f"transfer_planes: geometry must be (K, 2 + G) float64 with "
            f"G >= 1, got {tuple(geometry.shape)} {geometry.dtype}")
    if method not in ("rs", "fresnel") or not 1 <= n * n < 2 ** 31:
        raise ValueError(f"transfer_planes: method rs|fresnel and "
                         f"1 <= n * n < 2^31, got {method!r} and {n}")
    if not _on_card("transfer_planes", geometry):
        return ref.transfer_planes_ref(geometry, n, method, band_limit,
                                       polar)
    geometry = _dense(geometry)
    K, G = geometry.shape[0], geometry.shape[1] - 2
    a, b = (torch.empty((G * K, n, n), dtype=torch.float32,
                        device=geometry.device) for _ in range(2))
    lib = build.library("transfer_planes")
    build.check(lib, lib.transfer_planes(
        geometry.data_ptr(), a.data_ptr(), b.data_ptr(), K, G, n,
        int(method == "fresnel"), int(bool(band_limit)), int(bool(polar)),
        _stream(geometry.device), geometry.get_device(),
    ), "transfer_planes")
    _count("transfer_planes")
    return a, b


# the plain versions under the reference's ``ops`` names (holds and tests)
complex_mul_ref = ref.complex_mul_ref
phase_apply_ref = ref.phase_apply_ref
phase_tf_apply_ref = ref.phase_tf_apply_ref
fused_spectral_hop_ref = ref.fused_spectral_hop_ref
intensity_readout_ref = ref.intensity_readout_ref
rope_ref = ref.rope_ref
selective_scan_ref = ref.selective_scan_ref


# --------------------------------------------------------------------------
# autograd Functions: the reference's custom VJPs (repro/kernels/ops.py)
# --------------------------------------------------------------------------
def _dphase(g, out, P: int, nb: int):
    """d theta = sum over each plane's nb fields of (g_i out_r - g_r out_i),
    since d out / d theta = j out."""
    H, W = out.shape[-2:]
    cot = g.imag * out.real - g.real * out.imag
    return cot.reshape(P, nb, H, W).sum(dim=1)


class _PhaseTFApply(torch.autograd.Function):
    """K2 with the VJP of ``ops.py:177-189``: dx = K2(g, -theta, amp),
    d theta = sum_nb (g_i out_r - g_r out_i), d amp = 0 (static geometry)."""

    @staticmethod
    def forward(x, theta, amp, nb):
        return phase_tf_apply_planes(x, theta, amp, nb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, theta, amp, nb = inputs
        ctx.nb = nb
        ctx.save_for_backward(theta, amp, output)

    @staticmethod
    def backward(ctx, g):
        theta, amp, out = ctx.saved_tensors
        dx = dtheta = None
        if ctx.needs_input_grad[0]:
            dx = phase_tf_apply_planes(g, -theta, amp, ctx.nb)
        if ctx.needs_input_grad[1]:
            dtheta = _dphase(g, out, theta.shape[0], ctx.nb)
        return dx, dtheta, None, None


class _FusedHop(torch.autograd.Function):
    """The fused hop (two K1 passes) with the VJP of ``ops.py:287-305``:
    dx = ifft2(K2(fft2(K2(g, -theta_m, amp_m)), -theta_h, amp_h)),
    d theta_m = sum_nb (g_i out_r - g_r out_i); the TF planes and amp_m
    are static geometry (zero cotangent)."""

    @staticmethod
    def forward(x, th_h, amp_h, th_m, amp_m, nb):
        return _fused_hop_planes(x, (th_h, amp_h, th_m, amp_m), nb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, th_h, amp_h, th_m, amp_m, nb = inputs
        ctx.nb = nb
        ctx.save_for_backward(th_h, amp_h, th_m, amp_m, output)

    @staticmethod
    def backward(ctx, g):
        th_h, amp_h, th_m, amp_m, out = ctx.saved_tensors
        dx = dth_m = None
        if ctx.needs_input_grad[0]:
            v = phase_tf_apply_planes(g, -th_m, amp_m, ctx.nb)
            w = phase_tf_apply_planes(torch.fft.fft2(v), -th_h, amp_h, ctx.nb)
            dx = torch.fft.ifft2(w)
        if ctx.needs_input_grad[3]:
            dth_m = _dphase(g, out, th_m.shape[0], ctx.nb)
        return dx, None, None, dth_m, None, None


class _Readout(torch.autograd.Function):
    """K3 with the VJP of ``ops.py:390-397``: du = 2u (g @ masks), the
    masks are detector geometry (zero cotangent)."""

    @staticmethod
    def forward(u, masks):
        return intensity_readout_rows(u, masks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        u, masks = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        w = torch.einsum("bc,chw->bhw", g, masks)
        return u * (2.0 * w), None


class _PhaseApply(torch.autograd.Function):
    """K4 with the VJP of ``ops.py:115-125``: du = K4(g, -phi, gamma),
    d phi = sum_B (g_i out_r - g_r out_i)."""

    @staticmethod
    def forward(u, phi, gamma):
        return phase_apply_rows(u, phi, gamma)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, phi, gamma = inputs
        ctx.gamma = gamma
        ctx.save_for_backward(phi, output)

    @staticmethod
    def backward(ctx, g):
        phi, out = ctx.saved_tensors
        du = dphi = None
        if ctx.needs_input_grad[0]:
            du = phase_apply_rows(g, -phi, ctx.gamma)
        if ctx.needs_input_grad[1]:
            dphi = _dphase(g, out, 1, out.shape[0])[0]
        return du, dphi, None


class _ComplexMul(torch.autograd.Function):
    """K5 with the VJP of ``ops.py:69-76``: da = K5(g, conj(b)),
    db = sum_B g * conj(a)."""

    @staticmethod
    def forward(a, b):
        return complex_mul_rows(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = complex_mul_rows(g, b.conj())
        if ctx.needs_input_grad[1]:
            db = (g * a.conj()).sum(dim=0)
        return da, db


class _Rope(torch.autograd.Function):
    """K6 with the VJP of ``ops.py:464-466``: dx = K6(g, cos, -sin), a
    rotation by -theta; cos and sin get no cotangent."""

    @staticmethod
    def forward(x3, cos, sin):
        return rope_rows(x3, cos, sin)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, cos, sin = inputs
        ctx.save_for_backward(cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        dx = rope_rows(g, cos, -sin) if ctx.needs_input_grad[0] else None
        return dx, None, None


# --------------------------------------------------------------------------
# plane-stack contract (repro.kernels.ops)
# --------------------------------------------------------------------------
def _plane_major(x, pshape, H: int, W: int):
    """(..., *P, H, W) -> ((P*B, H, W) plane-major slabs, B, lead, squeeze)."""
    pdims = len(pshape)
    if tuple(x.shape[x.dim() - 2 - pdims: x.dim() - 2]) != tuple(pshape):
        raise ValueError(
            f"plane axes {tuple(pshape)} must match the corresponding axes "
            f"of x {tuple(x.shape)}"
        )
    squeeze = x.dim() == pdims + 2
    if squeeze:
        x = x[None]
    P = math.prod(pshape)
    lead = tuple(x.shape[: x.dim() - pdims - 2])
    x3 = x.reshape(-1, P, H, W).transpose(0, 1)
    B = x3.shape[1]
    return x3.reshape(P * B, H, W), B, lead, squeeze


def _from_plane_major(out, P: int, B: int, lead, pshape, H: int, W: int,
                      squeeze: bool):
    out = out.reshape(P, B, H, W).transpose(0, 1)
    out = out.reshape(lead + tuple(pshape) + (H, W))
    return out[0] if squeeze else out


def _apply_stacked(fn, x, planes):
    """Run ``fn(x3, planes3, nb)`` under the plane-stack contract."""
    pshape = tuple(planes[0].shape[:-2])
    H, W = planes[0].shape[-2:]
    if pshape:
        x3, B, lead, squeeze = _plane_major(x, pshape, H, W)
        P = math.prod(pshape)
        out = fn(x3, [p.reshape(P, H, W) for p in planes], B)
        return _from_plane_major(out, P, B, lead, pshape, H, W, squeeze)
    flat = x.reshape(-1, H, W)
    return fn(flat, [p[None] for p in planes], flat.shape[0]).reshape(x.shape)


def _apply_leading(fn, x, planes):
    """Run ``fn(x3, planes3, nb)`` with the plane axes *leading*: planes
    (*P, H, W) and x (*P, ..., H, W), so plane p owns the slabs [p*nb,
    (p+1)*nb) of x as it lies in memory — the kernels' plane-major
    contract with no transpose (a candidate-major field of
    ``emulate_batch``: P = (K,) or (K, C), nb the fields of each)."""
    pshape = tuple(planes[0].shape[:-2])
    H, W = planes[0].shape[-2:]
    if tuple(x.shape[:len(pshape)]) != pshape:
        raise ValueError(
            f"leading plane axes {pshape} must match the leading axes of x "
            f"{tuple(x.shape)}"
        )
    P = math.prod(pshape)
    x3 = x.reshape(-1, H, W)
    out = fn(x3, [p.reshape(P, H, W) for p in planes], x3.shape[0] // P)
    return out.reshape(x.shape)


def _lead_aligned(planes):
    """Planes with leading plane axes broadcast to one shape: each gets
    unit axes *after* its own leading axes (a (K, H, W) transfer plane
    against (K, C, H, W) phases is (K, 1, H, W)), then expands."""
    r = max(p.dim() for p in planes)
    planes = [p.reshape(tuple(p.shape[:-2]) + (1,) * (r - p.dim())
                        + tuple(p.shape[-2:])) for p in planes]
    bshape = torch.broadcast_shapes(*(p.shape for p in planes))
    return tuple(p.expand(bshape).contiguous() for p in planes)


def phase_tf_apply(x, theta, amp, lead: bool = False):
    """x * amp * exp(j theta) through K2 (``ops.phase_tf_apply``'s contract).

    x: complex (..., H, W); theta/amp: (H, W) shared by every field, or a
    plane stack (*P, H, W) with x: (..., *P, H, W).  ``lead=True`` takes
    the plane axes leading instead, x: (*P, ..., H, W) (``_apply_leading``).
    """
    fn = lambda x3, p, nb: _PhaseTFApply.apply(x3, p[0], p[1], nb)  # noqa: E731
    if lead:
        return _apply_leading(fn, x, _lead_aligned((theta, amp)))
    return _apply_stacked(fn, x, (theta, amp))


def _fused_hop_planes(x3, planes, nb: int):
    th_h, amp_h, th_m, amp_m = planes
    H, W = x3.shape[-2:]
    s = torch.fft.fft2(x3)
    t = conj_phase_scale(s, th_h, amp_h, nb, -1.0, 1.0)
    w = torch.fft.fft2(t)
    return conj_phase_scale(w, th_m, amp_m, nb, 1.0, 1.0 / (H * W))


def fused_spectral_hop(x, theta_h, amp_h, theta_m, amp_m, lead: bool = False):
    """One hop + modulation, M . ifft2(Hc . fft2(x)), through two K1 passes.

    fft2 -> K1(-theta_h, amp_h) -> fft2 -> K1(+theta_m, amp_m / (H*W)), via
    ifft2(y) = conj(fft2(conj(y))) / (H*W) — the reference's structure, so
    the port stays numerically close to it.  The four planes broadcast to
    one shape: (H, W) for every field or a (*P, H, W) stack — outside the
    autograd Function, so d theta_m folds back to the caller's shape.
    ``lead=True`` takes the plane axes leading, x: (*P, ..., H, W), as
    ``phase_tf_apply`` does.
    """
    planes = (theta_h, amp_h, theta_m, amp_m)
    fn = lambda x3, p, nb: _FusedHop.apply(x3, *p, nb)  # noqa: E731
    if lead:
        return _apply_leading(fn, x, _lead_aligned(planes))
    bshape = torch.broadcast_shapes(*(p.shape for p in planes))
    planes = tuple(p.expand(bshape).contiguous() for p in planes)
    return _apply_stacked(fn, x, planes)


def intensity_readout(u, masks):
    """(..., H, W) complex fields + (C, H, W) masks -> (..., C) through K3."""
    H, W = u.shape[-2:]
    out = _Readout.apply(u.reshape(-1, H, W), masks)
    return out.reshape(tuple(u.shape[:-2]) + (masks.shape[0],))


def channel_intensity_readout(u, masks, dim: int = -3):
    """(..., C, H, W) multi-channel fields + (K, H, W) masks -> (..., K).

    The RGB detector (``ops.channel_intensity_readout``): K3 over the
    (B*C) field rows, then the incoherent sum over the channels.  No new
    kernel and no atomics, so a retried batch stays bit-identical.
    ``dim`` names the channel axis of u (a candidate-major (K, C, B, H, W)
    field of ``emulate_batch`` has it at 1): K3 reads the rows in memory
    order whatever it is.
    """
    return intensity_readout(u, masks).sum(dim=dim + 1 if dim < 0 else dim)


def phase_apply(u, phi, gamma: float = 1.0):
    """gamma * u * exp(j phi) through K4 (``ops.phase_apply``'s contract).

    u: complex (..., H, W) (a 2-D field is one field); phi: one (H, W)
    plane shared by every field; gamma a Python float.
    """
    H, W = u.shape[-2:]
    if tuple(phi.shape) != (H, W):
        raise ValueError(
            f"phase_apply: phase {tuple(phi.shape)} must be one (H, W) plane "
            f"matching the fields {tuple(u.shape)}"
        )
    out = _PhaseApply.apply(u.reshape(-1, H, W), phi, float(gamma))
    return out.reshape(u.shape)


def complex_mul(a, b):
    """a * b through K5 (``ops.complex_mul``'s contract, complex64).

    a: (B, H, W) fields or one (H, W) field; b: one (H, W) plane shared by
    every field.
    """
    squeeze = a.dim() == 2
    out = _ComplexMul.apply(a[None] if squeeze else a, b)
    return out[0] if squeeze else out


def apply_rope(x, cos, sin):
    """x: (..., S, D) rotate-half RoPE with cos/sin (S, D//2) through K6.

    x, cos and sin share one dtype (float32 or bfloat16), as
    ``models.layers.apply_rotary`` casts them.  On the card the kernel
    computes in float32 and rounds once, where the plain version rounds
    each bf16 product: in bf16 the two agree within
    ``ref.rope_rounding_bound`` (3 * 2^-8 * (|x1 c| + |x2 s|) per
    element), in float32 within 1e-6 of the max.
    """
    lead = x.shape[:-2]
    S, D = x.shape[-2:]
    out = _Rope.apply(x.reshape((-1, S, D)), cos, sin)
    return out.reshape(tuple(lead) + (S, D))
