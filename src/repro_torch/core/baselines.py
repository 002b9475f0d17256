"""Reproduced baselines the paper compares against.

1. ``LightPipesLikeEngine`` — an emulation engine with the limitations the
   paper attributes to LightPipes (Table 1 / §5.3): no batched tensor
   representation (python loop over samples), no operator fusion or kernel
   caching (the transfer function is rebuilt every call), float64 complex
   arithmetic, eager execution (no jit).  Used by the Fig. 8/9 runtime
   benchmarks as the comparison point.

2. Training-method baseline of [34, 67]: DONN training *without* the
   physics-aware complex-valued regularization — i.e. our DONN with
   gamma=1.0 — used by the Fig. 7 / Table 5 / Fig. 13 comparisons.

A copy of ``repro.core.baselines`` on the port's own ``Grid`` (numpy, no
device: the baseline is the unoptimized comparison point by design).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.diffraction import Grid


class LightPipesLikeEngine:
    """Deliberately-unoptimized scalar diffraction emulation (numpy, eager)."""

    def __init__(self, grid: Grid, wavelength: float):
        self.grid = grid
        self.wavelength = wavelength

    # -- every step below is its own un-fused operator, rebuilt per call --
    def _transfer(self, z: float) -> np.ndarray:
        n, dx = self.grid.n, self.grid.pixel_size
        f = np.fft.fftfreq(n, d=dx)
        fx, fy = np.meshgrid(f, f, indexing="ij")
        k = 2.0 * math.pi / self.wavelength
        arg = 1.0 - (self.wavelength * fx) ** 2 - (self.wavelength * fy) ** 2
        kz = k * np.sqrt(np.maximum(arg, 0.0))
        kappa = k * np.sqrt(np.maximum(-arg, 0.0))
        return np.where(arg >= 0, np.exp(1j * kz * z), np.exp(-kappa * abs(z)))

    def fft2(self, u: np.ndarray) -> np.ndarray:
        return np.fft.fft2(u.astype(np.complex128))

    def ifft2(self, u: np.ndarray) -> np.ndarray:
        return np.fft.ifft2(u)

    def complex_mm(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return a * b

    def propagate_one(self, u: np.ndarray, z: float) -> np.ndarray:
        h = self._transfer(z)  # rebuilt every call (no caching)
        return self.ifft2(self.complex_mm(self.fft2(u), h))

    def propagate_batch(self, u_batch: np.ndarray, z: float) -> np.ndarray:
        # no tensor representation: python loop over the batch
        return np.stack(
            [self.propagate_one(u_batch[i], z) for i in range(u_batch.shape[0])]
        )

    def modulate_one(self, u: np.ndarray, phi: np.ndarray) -> np.ndarray:
        return self.complex_mm(u, np.exp(1j * phi.astype(np.complex128)))

    def donn_forward(self, x: np.ndarray, phases, distances) -> np.ndarray:
        """Full DONN forward, sample-by-sample (x: (B, n, n) real)."""
        out = []
        for i in range(x.shape[0]):
            u = x[i].astype(np.complex128)
            for li, phi in enumerate(phases):
                u = self.propagate_one(u, distances[li])
                u = self.modulate_one(u, np.asarray(phi))
            u = self.propagate_one(u, distances[-1])
            out.append(np.abs(u) ** 2)
        return np.stack(out)
