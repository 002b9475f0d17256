"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel computes, with the
reference Pallas kernel's operand order, on the plane-major layout the
wrappers in ``ops`` hand to the kernels: ``x`` is (P*nb, H, W) complex64,
``theta``/``amp`` are (P, H, W) float32 and plane p applies to the slab
``x[p*nb:(p+1)*nb]``.  The wrappers run these for tensors on the CPU (the
tests); ``chip_smoke.py`` runs them on the card to hold each kernel
against them.  Nothing on the serving path calls them for a CUDA tensor.
"""
from __future__ import annotations

import torch


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


def intensity_readout_ref(u, masks):
    """|u|^2 pooled per detector region: (B,H,W)x(C,H,W) -> (B,C) (K3)."""
    inten = u.real * u.real + u.imag * u.imag
    return torch.einsum("bhw,chw->bc", inten, masks)
