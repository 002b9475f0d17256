"""Laser-source modeling (LightRidge `lr.laser`), PyTorch side.

``Laser.field`` is the reference's numpy build-time constant, copied from
``repro.core.laser``; the input encoders are torch on the input's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.diffraction import Grid

PLANE = "plane"
GAUSSIAN = "gaussian"
BESSEL = "bessel"


@dataclasses.dataclass(frozen=True)
class Laser:
    """CW laser source: wavelength [m] + spatial beam profile."""

    wavelength: float = 532e-9
    profile: str = PLANE
    waist: Optional[float] = None  # 1/e^2 waist for gaussian / radial scale for bessel
    power: float = 1.0

    def field(self, grid: Grid) -> np.ndarray:
        """Complex source field on the grid (build-time constant)."""
        c = grid.coords()
        xx, yy = np.meshgrid(c, c, indexing="ij")
        r2 = xx**2 + yy**2
        if self.profile == PLANE:
            amp = np.ones((grid.n, grid.n))
        elif self.profile == GAUSSIAN:
            w = self.waist if self.waist is not None else grid.extent / 4.0
            amp = np.exp(-r2 / (w * w))
        elif self.profile == BESSEL:
            w = self.waist if self.waist is not None else grid.extent / 8.0
            kr = np.sqrt(r2) / w
            # J0(x) = (1/pi) int_0^pi cos(x sin t) dt, sampled coarsely
            # (exact enough for a source profile)
            t = np.linspace(0.0, math.pi, 64)
            amp = np.trapezoid(
                np.cos(kr[..., None] * np.sin(t)), t, axis=-1
            ) / math.pi
        else:
            raise ValueError(f"unknown beam profile {self.profile!r}")
        amp = amp * math.sqrt(self.power)
        return amp.astype(np.complex64)


def data_to_cplex(x: torch.Tensor, grid_n: Optional[int] = None) -> torch.Tensor:
    """Encode real-valued inputs (..., H, W) as complex fields (paper §3.1).

    Amplitude = input value, phase = 0; images smaller than the grid are
    nearest-upsampled and center-padded onto it (``resize_to_grid``).
    """
    return data_to_real(x, grid_n).to(torch.complex64)


def data_to_real(x: torch.Tensor, grid_n: Optional[int] = None) -> torch.Tensor:
    """``data_to_cplex`` without the complex cast (imag is exactly zero).

    The real-to-complex first-hop serving path (``rfft_first``) keeps the
    encoded field real so hop 0 runs as half-spectrum rFFTs.
    """
    x = x.to(torch.float32)
    if grid_n is not None and x.shape[-1] != grid_n:
        x = resize_to_grid(x, grid_n)
    return x


def resize_to_grid(x: torch.Tensor, n: int, mode: str = "upsample") -> torch.Tensor:
    """Nearest-neighbour upsample (or center-embed) (..., h, w) -> (..., n, n)."""
    h, w = x.shape[-2], x.shape[-1]
    if mode == "embed" or n < h:
        if n < h:
            raise ValueError("grid smaller than image")
        out = x.new_zeros(x.shape[:-2] + (n, n))
        oy, ox = (n - h) // 2, (n - w) // 2
        out[..., oy:oy + h, ox:ox + w] = x
        return out
    # nearest-neighbour upsample then center-pad remainder
    sy, sx = n // h, n // w
    up = x.repeat_interleave(sy, dim=-2).repeat_interleave(sx, dim=-1)
    py, px = n - up.shape[-2], n - up.shape[-1]
    return F.pad(up, (px // 2, px - px // 2, py // 2, py - py // 2))
