"""FFT-based scalar-diffraction physics (LightRidge §3.1), PyTorch side.

The static geometry — sampling grids and transfer functions — is numpy,
copied from ``repro.core.diffraction`` so the port imports nothing of the
JAX package; tests/test_torch_geometry.py pins the planes bit-equal to the
reference's.  The field operators (``propagate_tf``, pad/crop,
``intensity``) are torch, on whatever device the field lives on.  FFTs are
``torch.fft`` (cuFFT on the card), as the reference leaves its FFTs to XLA
outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

RS = "rs"
FRESNEL = "fresnel"
FRAUNHOFER = "fraunhofer"
METHODS = (RS, FRESNEL, FRAUNHOFER)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform square sampling grid for an optical field."""

    n: int  # samples per side (system size / resolution)
    pixel_size: float  # diffraction unit size [m]

    @property
    def extent(self) -> float:
        return self.n * self.pixel_size

    def freqs(self, pad: bool = False) -> np.ndarray:
        n = 2 * self.n if pad else self.n
        return np.fft.fftfreq(n, d=self.pixel_size)

    def coords(self) -> np.ndarray:
        # centered spatial coordinates of sample centers
        return (np.arange(self.n) - (self.n - 1) / 2.0) * self.pixel_size


def fresnel_tf_centered(
    grid: Grid, z: float, wavelength: float, pad: bool = False
) -> np.ndarray:
    """Fresnel transfer function over *centered* (fftshift-ordered) freqs.

    ``transfer_function`` folds the fftshift/ifftshift pair into the
    stored plane, so the runtime hop is a bare ``ifft2(fft2(u) * H)``.
    """
    f = np.fft.fftshift(grid.freqs(pad=pad))
    fx, fy = np.meshgrid(f, f, indexing="ij")
    k = 2.0 * math.pi / wavelength
    return (
        np.exp(1j * k * z)
        * np.exp(-1j * math.pi * wavelength * z * (fx**2 + fy**2))
    ).astype(np.complex64)


def transfer_function(
    grid: Grid,
    z: float,
    wavelength: float,
    method: str = RS,
    band_limit: bool = True,
    pad: bool = False,
) -> np.ndarray:
    """Free-space transfer function H(fx, fy) on the (possibly padded) grid.

    numpy complex64, stored pre-shifted (natural ``fftfreq`` ordering).
    """
    if method not in (RS, FRESNEL):
        raise ValueError(f"transfer_function supports rs|fresnel, got {method}")
    f = grid.freqs(pad=pad)
    fx, fy = np.meshgrid(f, f, indexing="ij")
    k = 2.0 * math.pi / wavelength
    if method == RS:
        # exact angular spectrum: H = exp(j k z sqrt(1 - (l fx)^2 - (l fy)^2))
        arg = 1.0 - (wavelength * fx) ** 2 - (wavelength * fy) ** 2
        prop = arg >= 0.0
        kz = k * np.sqrt(np.maximum(arg, 0.0))
        kappa = k * np.sqrt(np.maximum(-arg, 0.0))
        h = np.where(prop, np.exp(1j * kz * z), np.exp(-kappa * abs(z)))
    else:
        h = np.fft.ifftshift(fresnel_tf_centered(grid, z, wavelength, pad))
    if band_limit:
        # Matsushima & Shimobaba band-limited angular spectrum
        n = 2 * grid.n if pad else grid.n
        s = n * grid.pixel_size
        f_limit = 1.0 / (wavelength * math.sqrt((2.0 * z / s) ** 2 + 1.0))
        h = h * ((np.abs(fx) <= f_limit) & (np.abs(fy) <= f_limit))
    return h.astype(np.complex64)


def fraunhofer_quad(grid: Grid, z: float, wavelength: float) -> np.ndarray:
    """Far-field output-plane factor of Eq. 4 (quadratic phase + scaling)."""
    n = grid.n
    k = 2.0 * math.pi / wavelength
    x = np.fft.fftshift(np.fft.fftfreq(n, d=grid.pixel_size)) * wavelength * z
    xx, yy = np.meshgrid(x, x, indexing="ij")
    quad = np.exp(1j * k * z) * np.exp(1j * k / (2.0 * z) * (xx**2 + yy**2))
    scale = grid.pixel_size**2 / (1j * wavelength * z)
    return (quad * scale).astype(np.complex64)


def propagate_tf(u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Angular-spectrum propagation of field(s) u (..., N, N) by TF h."""
    return torch.fft.ifft2(torch.fft.fft2(u) * h)


def pad_field(u: torch.Tensor, n: int) -> torch.Tensor:
    """Center-embed an (..., n, n) field into the 2x zero-padded grid."""
    lo, hi = n // 2, n - n // 2
    return F.pad(u, (lo, hi, lo, hi))


def crop_field(u: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pad_field``: recover the central (..., n, n) window."""
    lo = n // 2
    return u[..., lo:lo + n, lo:lo + n]


def intensity(u: torch.Tensor) -> torch.Tensor:
    """|U|^2 — detector-plane light intensity."""
    return (u.real**2 + u.imag**2).to(torch.float32)
