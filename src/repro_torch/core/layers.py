"""Model-level DONN layers (LightRidge `lr.layers`), PyTorch side.

- ``DiffractiveLayer``: free-space propagation over z followed by trainable
  phase modulation — the eager engine's layer.  With ``use_pallas`` the
  modulation runs the hand-written K4 kernel (``kernels.ops.phase_apply``)
  on the card, forward and backward; the hop is the plain angular-spectrum
  ``propagate_tf`` (cuFFT), as in the reference.
- ``Detector``: pre-defined per-class readout regions: the field's
  intensity is pooled over each region (the paper's optical detector +
  ADC).  With ``use_pallas`` the readout runs the K3 kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import codesign as cd
from repro_torch.core import diffraction as df
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.nn.module import ParamSpec


class DiffractiveLayer:
    """One diffractive layer: propagate(z) then phase-modulate.

    The transfer function is precomputed at build time (static numpy
    geometry) and uploaded once per torch device at first use; the
    trainable parameter is the (n, n) phase map.  ``device`` is the
    codesign ``DeviceSpec`` (the reference's name); the torch device is the
    field's.
    """

    def __init__(
        self,
        grid: df.Grid,
        z: float,
        wavelength: float,
        method: str = df.RS,
        band_limit: bool = True,
        pad: bool = False,
        device: Optional[cd.DeviceSpec] = None,
        codesign_mode: str = "none",
        gamma: float = 1.0,
        use_pallas: bool = False,
    ):
        self.grid = grid
        self.z = z
        self.wavelength = wavelength
        self.method = method
        self.pad = pad
        self.device = device
        self.codesign_mode = codesign_mode
        self.gamma = gamma
        self.use_pallas = use_pallas
        if method == df.FRAUNHOFER:
            self.h = None  # df.fraunhofer at call time
        else:
            from repro_torch.core.propagation import cached_transfer_function

            self.h = cached_transfer_function(grid, z, wavelength, method,
                                              band_limit, pad=pad)
        self._h_dev: dict = {}  # str(torch device) -> uploaded TF

    def param_spec(self) -> ParamSpec:
        n = self.grid.n
        return ParamSpec((n, n), torch.float32, ("field_h", "field_w"),
                         init="uniform_phase")

    def propagate(self, u: torch.Tensor) -> torch.Tensor:
        if self.method == df.FRAUNHOFER:
            return df.fraunhofer(u, self.grid, self.z, self.wavelength)
        key = str(u.device)
        h = self._h_dev.get(key)
        if h is None:
            h = self._h_dev[key] = torch.from_numpy(self.h).to(u.device)
        if self.pad:
            n = self.grid.n
            return df.crop_field(df.propagate_tf(df.pad_field(u, n), h), n)
        return df.propagate_tf(u, h)

    def phase(self, phi: torch.Tensor, rng=None) -> torch.Tensor:
        """The phase the device holds for ``phi``: its codesign response,
        with one Gumbel draw from ``rng`` (a ``torch.Generator``) in the
        stochastic modes.  A (C, n, n) stack shares the draw."""
        return cd.apply_codesign(phi, self.device, self.codesign_mode, rng)

    def apply_phase(self, phi_eff: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
        """gamma * u * exp(j phi_eff) for an already resolved phase: K4
        under ``use_pallas``."""
        if self.use_pallas:
            return kops.phase_apply(u, phi_eff, self.gamma)
        return u * (self.gamma * torch.exp(1j * phi_eff.to(torch.complex64)))

    def modulate(self, phi: torch.Tensor, u: torch.Tensor,
                 rng=None) -> torch.Tensor:
        return self.apply_phase(self.phase(phi, rng), u)

    def __call__(self, phi: torch.Tensor, u: torch.Tensor,
                 rng=None) -> torch.Tensor:
        return self.modulate(phi, self.propagate(u), rng)


def detector_region_coords(
    n: int, num_classes: int, det_size: int, layout: str = "grid"
) -> list[tuple[int, int]]:
    """Top-left (y, x) corners of per-class detector regions.

    "grid": classes arranged in balanced rows centered on the plane (the
    3-4-3 style layout of Lin et al. for 10 classes generalized).
    "ring": regions on a circle (alternative layout for many classes).
    """
    coords: list[tuple[int, int]] = []
    if layout == "ring":
        r = 0.33 * n
        for c in range(num_classes):
            a = 2.0 * math.pi * c / num_classes
            y = int(n / 2 + r * math.sin(a)) - det_size // 2
            x = int(n / 2 + r * math.cos(a)) - det_size // 2
            coords.append((y, x))
        return coords
    rows = max(1, int(round(math.sqrt(num_classes))))
    base, extra = divmod(num_classes, rows)
    counts = [base + (1 if i < extra else 0) for i in range(rows)]
    # interleave so middle rows get the extras (3-4-3 for 10/3)
    counts.sort()
    mid = len(counts) // 2
    ordered = sorted(range(rows), key=lambda i: abs(i - mid))
    row_counts = [0] * rows
    for cnt, i in zip(sorted(counts, reverse=True), ordered):
        row_counts[i] = cnt
    lo, hi = 0.18 * n, 0.82 * n
    ys = np.linspace(lo, hi, rows + 1)
    ys = 0.5 * (ys[:-1] + ys[1:])
    for ri, cnt in enumerate(row_counts):
        xs = np.linspace(lo, hi, cnt + 1)
        xs = 0.5 * (xs[:-1] + xs[1:])
        for x in xs:
            coords.append((int(ys[ri]) - det_size // 2, int(x) - det_size // 2))
    return coords[:num_classes]


class Detector:
    """lr.layers.detector: per-class region intensity pooling.

    ``masks`` is the (C, n, n) float32 numpy geometry (as the reference's);
    ``masks_t`` the same planes on ``device``.
    """

    def __init__(
        self,
        grid: df.Grid,
        num_classes: int,
        det_size: int,
        layout: str = "grid",
        use_pallas: bool = False,
        device: Optional[torch.device] = None,
    ):
        n = grid.n
        self.grid = grid
        self.num_classes = num_classes
        self.det_size = det_size
        self.use_pallas = use_pallas
        coords = detector_region_coords(n, num_classes, det_size, layout)
        self.coords = coords
        masks = np.zeros((num_classes, n, n), np.float32)
        for c, (y, x) in enumerate(coords):
            masks[c, y : y + det_size, x : x + det_size] = 1.0
        self.masks = masks
        self.masks_t = torch.from_numpy(masks).to(resolve_device(device))

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """Field (..., n, n) -> per-class intensities (..., C)."""
        if self.use_pallas:
            return kops.intensity_readout(u, self.masks_t)
        return torch.einsum("...hw,chw->...c", df.intensity(u), self.masks_t)

    def intensity_image(self, u: torch.Tensor) -> torch.Tensor:
        """The whole detector-plane intensity |u|^2 (..., n, n)."""
        return df.intensity(u)
