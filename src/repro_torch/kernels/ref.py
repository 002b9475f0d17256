"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes what its CUDA kernel computes, with the reference
Pallas kernel's operand order (K6 in bf16 rounds after each product,
where the kernel rounds once), on the plane-major layout the
wrappers in ``ops`` hand to the kernels: ``x`` is (P*nb, H, W) complex64,
``theta``/``amp`` are (P, H, W) float32 and plane p applies to the slab
``x[p*nb:(p+1)*nb]``; K4 takes (B, H, W) fields and one shared (H, W)
phase plane; K5-K7 take the shapes of their public wrappers, and
``transfer_planes_ref`` a candidate set's geometry table.  The
wrappers run these for tensors on the CPU (the tests);
``chip_smoke.py`` runs them on the card to hold each kernel against them.
Nothing on the serving or training path calls them for a CUDA tensor.
"""
from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi
_TWO_PI_HI = float.fromhex("0x1.921fb5p+2")  # 2 pi's top 26 bits
_TWO_PI_LO = _TWO_PI - _TWO_PI_HI  # exact
_INV_TWO_PI = 1.0 / _TWO_PI


def _slabs(x: torch.Tensor, theta: torch.Tensor, amp: torch.Tensor, nb: int):
    P, H, W = theta.shape
    xv = x.reshape(P, nb, H, W)
    return xv.real, xv.imag, theta[:, None], amp[:, None]


def conj_phase_scale_ref(x, theta, amp, nb: int, sign: float, scale: float):
    """conj(x) * amp * scale * exp(sign * j * theta) (K1)."""
    xr, xi, th, a = _slabs(x, theta, amp, nb)
    c = torch.cos(th) * a * scale
    s = torch.sin(th) * (a * (sign * scale))
    return torch.complex(xr * c + xi * s, xr * s - xi * c).reshape(x.shape)


def phase_tf_apply_ref(x, theta, amp, nb: int):
    """x * amp * exp(j theta) (K2)."""
    xr, xi, th, a = _slabs(x, theta, amp, nb)
    c = torch.cos(th) * a
    s = torch.sin(th) * a
    return torch.complex(xr * c - xi * s, xr * s + xi * c).reshape(x.shape)


def fused_spectral_hop_ref(x, theta_h, amp_h, theta_m, amp_m):
    """One propagation hop + modulation, M . ifft2(Hc . fft2(x)), unfused:
    the definition the fused hop's two K1 passes compute
    (``ops.fused_spectral_hop``).  x: complex (..., H, W); Hc = amp_h *
    exp(j theta_h) and M = amp_m * exp(j theta_m) broadcast against x.
    For holds only: no path runs it."""
    hc = amp_h * torch.exp(1j * theta_h.to(torch.complex64))
    m = amp_m * torch.exp(1j * theta_m.to(torch.complex64))
    return m * torch.fft.ifft2(hc * torch.fft.fft2(x))


def phase_apply_ref(u, phi, gamma: float):
    """gamma * u * exp(j phi), phi one (H, W) plane for every field (K4)."""
    c = torch.cos(phi) * gamma
    s = torch.sin(phi) * gamma
    return torch.complex(u.real * c - u.imag * s, u.real * s + u.imag * c)


def intensity_readout_ref(u, masks):
    """|u|^2 pooled per detector region: (B,H,W)x(C,H,W) -> (B,C) (K3)."""
    inten = u.real * u.real + u.imag * u.imag
    return torch.einsum("bhw,chw->bc", inten, masks)


def complex_mul_ref(a, b):
    """a * b, one (H, W) plane b for every field of a (B, H, W) (K5)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def rope_ref(x, cos, sin):
    """Rotate-half RoPE in x's dtype, the Pallas kernel's body (K6):
    x (BN, S, D), cos/sin (S, D//2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_rounding_bound(x, cos, sin):
    """Per element, how far K6 in bf16 may lie from ``rope_ref``.

    The plain version rounds x1*c and x2*s to bf16 and then their
    difference (sum); the kernel computes exactly in f32 and rounds once.
    Two half-ulp roundings of the products and one of each result give
    |kernel - plain| <= 3 * 2^-8 * (|x1 c| + |x2 s|) for the first half
    (|x2 c| + |x1 s| for the second); the f32 rounding inside the kernel
    adds under 2^-23 of that.  x (..., S, D), cos/sin (S, D//2) in x's
    dtype; returns float32 of x's shape.
    """
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    c, s = cos.float(), sin.float()
    first = (x1 * c).abs() + (x2 * s).abs()
    second = (x2 * c).abs() + (x1 * s).abs()
    return 3.0 * 2.0 ** -8 * torch.cat([first, second], dim=-1)


def selective_scan_ref(dt, x, bs, cs, a):
    """The mamba-1 scan forward from h = 0 (K7): the model's chunked scan
    (``repro_torch.models.ssm._selective_scan``) at chunk 64, in float32,
    as the reference's ``ops.selective_scan_ref``."""
    from repro_torch.models.ssm import _selective_scan

    B, S, D = x.shape
    h0 = torch.zeros((B, D, a.shape[-1]), dtype=torch.float32,
                     device=x.device)
    y, _ = _selective_scan(dt.float(), bs.float(), cs.float(), x.float(),
                           a.float(), h0, chunk=64)
    return y


def _wrap(t):
    """t less its nearest multiple of 2 pi, as the kernel reduces it:
    Cody-Waite, q = round(t / 2 pi), then t - q C1 - q C2 with C1 + C2 =
    2 pi in double and q C1 exact."""
    q = torch.round(t * _INV_TWO_PI)
    return (t - q * _TWO_PI_HI) - q * _TWO_PI_LO


def transfer_planes_ref(geometry, n: int, method: str, band_limit: bool,
                        polar: bool):
    """The transfer planes of a candidate set (``transfer_planes``), in
    f64: ``diffraction.transfer_function`` for every candidate and gap,
    operation for operation, with the phase reduced mod 2 pi before it is
    rounded to f32.

    geometry: (K, 2 + G) float64, each row a candidate's pixel size,
    wavelength and G distances [m]; n: the plane size (2x under ``pad``);
    method ``"rs"`` or ``"fresnel"``.  Returns two (G*K, n, n) float32
    planes, row g*K + k candidate k's gap g: (arg H, |H|) when ``polar``,
    (Re H, Im H) otherwise.
    """
    geo = geometry.to(torch.float64)
    G = geo.shape[1] - 2
    dx = geo[:, 0].repeat(G)[:, None, None]  # row g*K + k: candidate k
    lam = geo[:, 1].repeat(G)[:, None, None]
    z = geo[:, 2:].T.reshape(-1)[:, None, None]
    m = torch.arange(n, dtype=torch.float64, device=geo.device)
    m = torch.where(m < (n - 1) // 2 + 1, m, m - n)  # numpy's fftfreq order
    step = torch.reciprocal(n * dx)
    fx, fy = m[:, None] * step, m[None, :] * step  # (R, n, 1), (R, 1, n)
    # a float over a tensor is a reciprocal and a product: divide once
    k0 = torch.div(_TWO_PI, lam)
    if method == "fresnel":
        c = -((math.pi * lam) * z)
        theta = _wrap(_wrap(k0 * z) + c * (fx * fx + fy * fy))
        amp = torch.ones_like(theta)
    else:
        lx, ly = lam * fx, lam * fy
        arg = (1.0 - lx * lx) - ly * ly
        prop = arg >= 0.0
        theta = torch.where(
            prop, _wrap(k0 * torch.sqrt(arg.clamp_min(0.0)) * z), 0.0)
        amp = torch.where(prop, 1.0, torch.exp(
            -(k0 * torch.sqrt((-arg).clamp_min(0.0))) * z.abs()))
    if band_limit:
        r = (2.0 * z) / (n * dx)
        f_limit = torch.reciprocal(lam * torch.sqrt(r * r + 1.0))
        keep = (fx.abs() <= f_limit) & (fy.abs() <= f_limit)
        theta = torch.where(keep, theta, 0.0)
        amp = torch.where(keep, amp, 0.0)
    if polar:
        return theta.float(), amp.float()
    return (amp * torch.cos(theta)).float(), (amp * torch.sin(theta)).float()
