"""Detector layer (LightRidge `lr.layers.detector`), PyTorch side.

Pre-defined per-class readout regions: the field's intensity is pooled
over each region (the paper's optical detector + ADC).  With
``use_pallas`` the readout runs the hand-written K3 kernel on the card.
The eager ``DiffractiveLayer`` (and its K4 kernel) comes with a later
slice.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import diffraction as df
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


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
