"""FFT-based scalar-diffraction physics (LightRidge §3.1), PyTorch side.

The static geometry — sampling grids and transfer functions — is numpy,
copied from ``repro.core.diffraction`` so the port imports nothing of the
JAX package; tests/test_torch_geometry.py pins the planes bit-equal to the
reference's.  The field operators (``propagate_tf``, pad/crop,
``intensity``, ``resample_field``) are torch, on whatever device the
field lives on.  FFTs are ``torch.fft`` (cuFFT on the card), as the
reference leaves its FFTs to XLA outside any Pallas kernel.  The one-shot
``propagate`` takes its plane from the port's transfer-function cache
(``propagation.cached_transfer_function``), so a repeated call builds no
plane anew and counts in ``tf_cache_stats``; the reference's builds one
each call and counts nothing.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cache import lru_get, lru_put

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


def propagate(
    u: torch.Tensor,
    grid: Grid,
    z: float,
    wavelength: float,
    method: str = RS,
    band_limit: bool = True,
    pad: bool = False,
) -> torch.Tensor:
    """One-shot propagation of field(s) u (..., n, n) over distance z.

    Fraunhofer is ``fraunhofer``; ``pad`` embeds u in the 2x zero-padded
    grid, hops there and crops the centre back; otherwise one
    ``propagate_tf`` with the (cached) transfer function on u's device.
    """
    if method == FRAUNHOFER:
        return fraunhofer(u, grid, z, wavelength)
    from repro_torch.core.propagation import cached_transfer_function

    h = torch.from_numpy(cached_transfer_function(
        grid, z, wavelength, method, band_limit, pad)).to(u.device)
    if pad:
        return crop_field(propagate_tf(pad_field(u, grid.n), h), grid.n)
    return propagate_tf(u, h)


def pad_field(u: torch.Tensor, n: int) -> torch.Tensor:
    """Center-embed an (..., n, n) field into the 2x zero-padded grid."""
    lo, hi = n // 2, n - n // 2
    return F.pad(u, (lo, hi, lo, hi))


def crop_field(u: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pad_field``: recover the central (..., n, n) window."""
    lo = n // 2
    return u[..., lo:lo + n, lo:lo + n]


def fraunhofer(u: torch.Tensor, grid: Grid, z: float,
               wavelength: float) -> torch.Tensor:
    """Far-field (Fraunhofer) propagation, Eq. 4: the shifted spectrum
    times the quadratic output factor (``fraunhofer_quad``)."""
    spec = torch.fft.fftshift(torch.fft.fft2(u), dim=(-2, -1))
    return spec * torch.from_numpy(
        fraunhofer_quad(grid, z, wavelength)).to(u.device)


# bounded LRU, the discipline of the propagation TF/plan caches
_RESAMPLE_CACHE: dict = {}
_RESAMPLE_CACHE_MAX = 256


def resample_matrix(grid_in: Grid, grid_out: Grid) -> np.ndarray:
    """Bilinear field-resampling operator between two plane grids.

    The (n_out, n_in) separable 1-D interpolation matrix ``A`` with
    ``u_out = A @ u_in @ A.T`` over *physical* coordinates (both grids
    centered; samples outside the input aperture read zero).  For equal
    pixel sizes and n_in, n_out of one parity it is an exact centered
    crop / zero-pad (0/1 entries).  Static numpy geometry, cached
    process-wide (LRU).
    """
    key = (grid_in.n, float(grid_in.pixel_size),
           grid_out.n, float(grid_out.pixel_size))
    hit = lru_get(_RESAMPLE_CACHE, key)
    if hit is not None:
        return hit
    # output sample positions in input index space
    t = (grid_out.coords() / grid_in.pixel_size) + (grid_in.n - 1) / 2.0
    i0 = np.floor(t).astype(np.int64)
    w = (t - i0).astype(np.float64)
    A = np.zeros((grid_out.n, grid_in.n), np.float64)
    rows = np.arange(grid_out.n)
    for idx, wt in ((i0, 1.0 - w), (i0 + 1, w)):
        ok = (idx >= 0) & (idx < grid_in.n)
        A[rows[ok], idx[ok]] += wt[ok]
    A = A.astype(np.float32)
    lru_put(_RESAMPLE_CACHE, key, A, _RESAMPLE_CACHE_MAX)
    return A


def _is_exact_crop_pad(grid_in: Grid, grid_out: Grid) -> bool:
    """True when the stitch degenerates to a centered crop / zero-pad:
    equal pitch and same parity, so the centered sample grids coincide."""
    return (float(grid_in.pixel_size) == float(grid_out.pixel_size)
            and (grid_in.n - grid_out.n) % 2 == 0)


def resample_field(u: torch.Tensor, grid_in: Grid,
                   grid_out: Grid) -> torch.Tensor:
    """Resample field(s) (..., n_in, n_in) onto ``grid_out`` (bilinear).

    The identity on equal grids; pure slicing / zero-padding for exact
    crop/pad stitches; otherwise two real contractions with
    ``resample_matrix`` (real and imaginary parts apart), as the reference
    runs them outside any kernel.
    """
    if grid_in == grid_out:
        return u
    if _is_exact_crop_pad(grid_in, grid_out):
        n_in, n_out = grid_in.n, grid_out.n
        if n_in >= n_out:
            off = (n_in - n_out) // 2
            return u[..., off:off + n_out, off:off + n_out]
        lo = (n_out - n_in) // 2
        hi = n_out - n_in - lo
        return F.pad(u, (lo, hi, lo, hi))
    A = torch.from_numpy(resample_matrix(grid_in, grid_out)).to(u.device)
    if u.is_complex():
        re = torch.einsum("oi,...ij,pj->...op", A, u.real, A)
        im = torch.einsum("oi,...ij,pj->...op", A, u.imag, A)
        return torch.complex(re, im)
    return torch.einsum("oi,...ij,pj->...op", A, u, A)


def fresnel_number(grid: Grid, z: float, wavelength: float) -> float:
    """Fresnel number a^2/(lambda z) with a = half-aperture (regime check).

    The reference's ``diffraction.fresnel_number``; ``physics.fresnel_number``
    is the per-geometry spelling the config validator uses."""
    a = grid.extent / 2.0
    return a * a / (wavelength * z)


def phase_to_field(phi: torch.Tensor) -> torch.Tensor:
    """exp(j phi) as complex64 from a real phase array."""
    return torch.exp(1j * phi.to(torch.complex64))


def intensity(u: torch.Tensor) -> torch.Tensor:
    """|U|^2 — detector-plane light intensity."""
    return (u.real**2 + u.imag**2).to(torch.float32)
