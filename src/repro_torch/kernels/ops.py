"""Wrappers around the port's hand-written Hopper kernels (K1-K3).

The public functions keep the JAX package's plane-stack contract
(``repro.kernels.ops``): ``theta``/``amp`` are one (H, W) plane shared by
every field, or a stack (*P, H, W) with x: (..., *P, H, W) so plane p
transforms the fields in slot p.  Fields are complex64 tensors; the
kernels read and write them interleaved (``torch.view_as_real`` layout,
what cuFFT returns), so no split into real/imag planes is needed.

Dispatch is by the tensor's device, never by a try: on a CUDA tensor the
wrapper launches its kernel (building it at first use) or raises; on a CPU
tensor it runs the plain PyTorch version in ``ref``, which exists for the
tests.  The kernels are forward only: on the card an input that requires
grad raises (the autograd Functions with the reference's VJPs come with
the training slice).  Planes in bf16 storage are upcast to f32 by the
callers before they get here.

Every launch adds one to ``LAUNCHES[name]`` — the count that shows a run
really went through the kernels (``reset_launch_counts`` /
``launch_counts``).
"""
from __future__ import annotations

import math
import threading

import torch

from repro_torch.kernels import build, ref

KERNELS = ("conj_phase_scale", "phase_tf_apply", "intensity_readout")
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
    """True for CUDA inputs (launch the kernel), False for CPU ones."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: the CUDA kernel is forward only and an input "
                "requires grad; its autograd Function comes with the "
                "training slice"
            )
    return True


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
    x, theta, amp = x.contiguous(), theta.contiguous(), amp.contiguous()
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
    x, theta, amp = x.contiguous(), theta.contiguous(), amp.contiguous()
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
    u, masks = u.contiguous(), masks.contiguous()
    B, H, W = u.shape
    C = masks.shape[0]
    lib = build.library("intensity_readout")
    tiles = -(-(H * W) // lib.readout_tile_pixels())
    partial = torch.empty((B, tiles, C), dtype=torch.float32, device=u.device)
    out = torch.empty((B, C), dtype=torch.float32, device=u.device)
    build.check(lib, lib.intensity_readout(
        u.data_ptr(), masks.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, H * W, C, _stream(u.device), u.get_device(),
    ), "intensity_readout")
    _count("intensity_readout")
    return out


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


def phase_tf_apply(x, theta, amp):
    """x * amp * exp(j theta) through K2 (``ops.phase_tf_apply``'s contract).

    x: complex (..., H, W); theta/amp: (H, W) shared by every field, or a
    plane stack (*P, H, W) with x: (..., *P, H, W).
    """
    return _apply_stacked(
        lambda x3, p, nb: phase_tf_apply_planes(x3, p[0], p[1], nb),
        x, (theta, amp),
    )


def _fused_hop_planes(x3, planes, nb: int):
    th_h, amp_h, th_m, amp_m = planes
    H, W = x3.shape[-2:]
    s = torch.fft.fft2(x3)
    t = conj_phase_scale(s, th_h, amp_h, nb, -1.0, 1.0)
    w = torch.fft.fft2(t)
    return conj_phase_scale(w, th_m, amp_m, nb, 1.0, 1.0 / (H * W))


def fused_spectral_hop(x, theta_h, amp_h, theta_m, amp_m):
    """One hop + modulation, M . ifft2(Hc . fft2(x)), through two K1 passes.

    fft2 -> K1(-theta_h, amp_h) -> fft2 -> K1(+theta_m, amp_m / (H*W)), via
    ifft2(y) = conj(fft2(conj(y))) / (H*W) — the reference's structure, so
    the port stays numerically close to it.  The four planes broadcast to
    one shape: (H, W) for every field or a (*P, H, W) stack.
    """
    planes = (theta_h, amp_h, theta_m, amp_m)
    bshape = torch.broadcast_shapes(*(p.shape for p in planes))
    planes = tuple(p.expand(bshape).contiguous() for p in planes)
    return _apply_stacked(_fused_hop_planes, x, planes)


def intensity_readout(u, masks):
    """(..., H, W) complex fields + (C, H, W) masks -> (..., C) through K3."""
    H, W = u.shape[-2:]
    out = intensity_readout_rows(u.reshape(-1, H, W), masks)
    return out.reshape(tuple(u.shape[:-2]) + (masks.shape[0],))
