"""DONN classifier (LightRidge `lr.models`), PyTorch side.

The port of ``repro.core.models.DONN`` on the plan ("scan") engine: a
stack of diffractive layers plus the class detector, forward only.  The
RGB multi-channel and segmentation families, the eager engine and the
batched emulation runtime come with later slices; asking for them raises
``NotImplementedError``.

Parameters are a plain nested dict in the reference's layout,
``{"phase": {"layer_i": (n, n) float32}}``, drawn from an explicit
``torch.Generator`` (``init``) or carried over from the JAX package
(``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import diffraction as df
from repro_torch.core.config import DONNConfig
from repro_torch.core.laser import Laser, data_to_cplex
from repro_torch.core.layers import Detector
from repro_torch.core.propagation import plan_from_config
from repro_torch.device import resolve_device


class DONN:
    """Sequential DONN classifier on ``device`` (the CUDA card by default)."""

    def __init__(self, cfg: DONNConfig, laser: Optional[Laser] = None,
                 device=None):
        if cfg.channels != 1:
            raise NotImplementedError(
                "multi-channel (RGB) DONNs come with the RGB/segmentation "
                "slice"
            )
        if cfg.engine != "scan":
            raise NotImplementedError(
                "the eager engine (and its phase_apply kernel) comes with a "
                "later slice; use engine='scan'"
            )
        if cfg.is_heterogeneous():
            raise NotImplementedError(
                "heterogeneous stacks come with the RGB/segmentation/"
                "heterogeneous slice"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.grid = df.Grid(cfg.n, cfg.pixel_size)  # detector/system grid
        self.laser = laser or Laser(wavelength=cfg.wavelength)
        self.gamma = 1.0 if cfg.gamma is None else float(cfg.gamma)
        self.in_grid = self.grid  # uniform stack: source plane = system grid
        self.depth = cfg.depth
        self._plan = None  # built on first use
        self.detector = Detector(
            self.grid,
            cfg.num_classes,
            cfg.det_size,
            cfg.detector_layout,
            use_pallas=cfg.use_pallas,
            device=self.device,
        )
        self.source = self.laser.field(self.in_grid)  # (n, n) complex64 const
        self.source_t = torch.from_numpy(self.source).to(self.device)

    @property
    def plan(self):
        if self._plan is None:
            self._plan = plan_from_config(self.cfg, self.gamma)
        return self._plan

    # --- params ---
    def param_shapes(self) -> dict:
        n = self.in_grid.n
        return {"phase": {f"layer_{i}": (n, n) for i in range(self.depth)}}

    def init(self, generator: torch.Generator) -> dict:
        """Phases uniform in [0, 2pi), drawn on the generator's device and
        placed on the model's, so one seed gives one model everywhere."""
        out = {}
        for name, shape in self.param_shapes()["phase"].items():
            u = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
            out[name] = (u * (2.0 * math.pi)).to(self.device)
        return {"phase": out}

    # --- forward ---
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return data_to_cplex(x, self.in_grid.n) * self.source_t

    def stacked_phases(self, params) -> torch.Tensor:
        """(L, N, N) phase stack in the plan's layout."""
        return self.plan.stack_phases(
            params["phase"][f"layer_{i}"] for i in range(self.depth)
        )

    def apply(self, params, x: torch.Tensor, rng=None) -> torch.Tensor:
        """Images (..., h, w) -> per-class detector intensities (..., C)."""
        u = self.plan.apply(self.stacked_phases(params), self.encode(x), rng)
        return self.detector(u)


def build_model(cfg: DONNConfig, laser: Optional[Laser] = None, device=None):
    """Factory used by the configs and the serving CLI (classify family)."""
    if cfg.segmentation:
        raise NotImplementedError(
            "segmentation DONNs come with the RGB/segmentation slice"
        )
    return DONN(cfg, laser, device=device)


def config_static_key(cfg: DONNConfig) -> tuple:
    """Hashable config key (canonicalized, drops the cosmetic name)."""
    cfg = cfg.canonical()
    d = dataclasses.asdict(cfg)
    d.pop("name")
    d["distances"] = cfg.gap_distances()
    d["distance"] = 0.0  # folded into the normalized distances
    if d["layers"] is not None:
        d["layers"] = tuple(
            tuple(sorted(l.items())) for l in d["layers"]
        )
    return tuple(sorted(d.items()))
