"""DONN model containers (LightRidge `lr.models`), PyTorch side.

The port of ``repro.core.models``:

- ``DONN``: a stack of diffractive layers plus the class detector;
- ``MultiChannelDONN``: the RGB architecture (paper Fig. 12), parallel
  optical channels whose output intensities add on one detector;
- ``SegmentationDONN``: the segmentation architecture (Fig. 13), with the
  optical skip connection (a beam-splitter sum of complex fields) and the
  train-time layer norm.

Each runs on either engine — ``"scan"``, the fused plan
(``PropagationPlan``, or ``SegmentedPlan`` for a heterogeneous config;
K1/K2 under ``use_pallas``), or ``"eager"``, the per-layer
``DiffractiveLayer`` loop (K4 under ``use_pallas``) that the reference
keeps as its own reference path.  Both are differentiable in the phases.
The batched emulation runtime comes with a later slice.

Parameters are a plain nested dict in the reference's layout,
``{"phase": {"layer_i": float32 tensor}}`` — (n_i, n_i) per layer (ragged
across a heterogeneous stack), (C, n, n) for the RGB DONN — drawn from an
explicit ``torch.Generator`` (``init``) or carried over from the JAX
package (``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import codesign as cd
from repro_torch.core import diffraction as df
from repro_torch.core.config import DONNConfig
from repro_torch.core.laser import Laser, data_to_cplex
from repro_torch.core.layers import Detector, DiffractiveLayer
from repro_torch.core.propagation import plan_from_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def channel_readout(u: torch.Tensor, masks: torch.Tensor,
                    use_pallas: bool) -> torch.Tensor:
    """Multi-channel detector accumulation, shared by every path.

    (..., C, n, n) per-channel output fields -> (..., num_classes): the
    incoherent channel sum pooled over the per-class detector regions,
    through K3 under ``use_pallas`` or one contraction otherwise.  Training
    (``MultiChannelDONN.apply``, both engines) and serving
    (``repro_torch.runtime.inference``) both read out here.
    """
    if use_pallas:
        return kops.channel_intensity_readout(u, masks)
    return torch.einsum("...dhw,chw->...c", df.intensity(u), masks)


def _build_layers(cfg: DONNConfig, gamma: float):
    """Eager per-layer stack from the (possibly heterogeneous) config: one
    ``DiffractiveLayer`` per modulated layer, each on its own grid, plus
    the final free-space hop to the detector on the last layer's grid (no
    modulation), as ``repro.core.models._build_layers``."""
    specs = cfg.resolved_layers()
    layers = [
        DiffractiveLayer(
            df.Grid(s.size, s.pixel_size), s.distance, cfg.wavelength,
            method=s.approximation, band_limit=cfg.band_limit, pad=cfg.pad,
            device=cd.device_for_layer(s.codesign, s.device_levels,
                                       s.response_gamma),
            codesign_mode=s.codesign, gamma=gamma,
            use_pallas=cfg.use_pallas,
        )
        for s in specs
    ]
    final = DiffractiveLayer(
        layers[-1].grid, cfg.gap_distances()[-1], cfg.wavelength,
        method=specs[-1].approximation, band_limit=cfg.band_limit,
        pad=cfg.pad, gamma=1.0, use_pallas=cfg.use_pallas,
    )
    return layers, final


def _uniform_phases(shapes: dict, generator: torch.Generator,
                    device) -> dict:
    """Phases uniform in [0, 2pi), drawn on the generator's device and
    placed on the model's, so one seed gives one model everywhere."""
    out = {}
    for name, shape in shapes["phase"].items():
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        out[name] = (u * (2.0 * math.pi)).to(device)
    return {"phase": out}


class _PhaseStack:
    """What the single-field containers share: the config's layers and
    plan, the source field, the phase parameters and the eager loop."""

    def __init__(self, cfg: DONNConfig, laser: Optional[Laser], device):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.grid = df.Grid(cfg.n, cfg.pixel_size)  # detector/system grid
        self.laser = laser or Laser(wavelength=cfg.wavelength)
        self.gamma = 1.0 if cfg.gamma is None else float(cfg.gamma)
        self.layers, self.final = _build_layers(cfg, self.gamma)
        self.in_grid = self.layers[0].grid  # source plane (first layer)
        self.depth = cfg.depth
        self._plan = None  # built on first scan-path use
        self.source = self.laser.field(self.in_grid)  # (n, n) complex64 const
        self.source_t = torch.from_numpy(self.source).to(self.device)

    @property
    def plan(self):
        if self._plan is None:
            self._plan = plan_from_config(self.cfg, self.gamma)
        return self._plan

    # --- params ---
    def param_shapes(self) -> dict:
        return {"phase": {f"layer_{i}": (l.grid.n, l.grid.n)
                          for i, l in enumerate(self.layers)}}

    def init(self, generator: torch.Generator) -> dict:
        return _uniform_phases(self.param_shapes(), generator, self.device)

    # --- forward ---
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return data_to_cplex(x, self.in_grid.n) * self.source_t

    def fields(self, params, x: torch.Tensor, rng=None) -> list:
        """All intermediate fields of the eager engine (lr.model.prop_view):
        the encoded input, each layer's output and the detector plane."""
        if rng is not None:
            raise NotImplementedError(
                "rng-driven codesign comes with the DSE/codesign slice"
            )
        u = self.encode(x)
        out = [u]
        cur = self.in_grid
        for i, layer in enumerate(self.layers):
            u = df.resample_field(u, cur, layer.grid)  # no-op on equal grids
            u = layer(params["phase"][f"layer_{i}"], u)
            cur = layer.grid
            out.append(u)
        u = self.final.propagate(u)
        out.append(df.resample_field(u, self.final.grid, self.grid))
        return out

    def stacked_phases(self, params):
        """Phase stack in the plan's layout: one (L, ...) tensor for a
        uniform stack, a per-segment tuple for a heterogeneous one."""
        return self.plan.stack_phases(
            params["phase"][f"layer_{i}"] for i in range(self.depth)
        )


class DONN(_PhaseStack):
    """Sequential DONN classifier on ``device`` (the CUDA card by default)."""

    def __init__(self, cfg: DONNConfig, laser: Optional[Laser] = None,
                 device=None):
        if cfg.channels != 1:
            raise ValueError("use MultiChannelDONN for channels > 1")
        super().__init__(cfg, laser, device)
        self.detector = Detector(
            self.grid,
            cfg.num_classes,
            cfg.det_size,
            cfg.detector_layout,
            use_pallas=cfg.use_pallas,
            device=self.device,
        )

    def apply(self, params, x: torch.Tensor, rng=None) -> torch.Tensor:
        """Images (..., h, w) -> per-class detector intensities (..., C)."""
        if self.cfg.engine == "eager":
            u = self.fields(params, x, rng)[-1]
        else:
            u = self.plan.apply(self.stacked_phases(params), self.encode(x),
                                rng)
        return self.detector(u)

    def prop_view(self, params, x: torch.Tensor, rng=None) -> list:
        return [df.intensity(u) for u in self.fields(params, x, rng)]


class MultiChannelDONN:
    """Multi-channel (RGB) DONN (paper Fig. 12).

    ``channels`` parallel optical stacks, each encoding one input channel;
    every output beam projects onto one shared detector where the
    intensities add.  The scan engine propagates all channels as one
    (B, C, N, N) field through the plan with an (L, C, N, N) phase stack;
    the eager engine runs each channel through ``channel_model.fields``
    with its own (N, N) planes, as the reference's ``vmap`` does.
    """

    def __init__(self, cfg: DONNConfig, laser: Optional[Laser] = None,
                 device=None):
        self.cfg = cfg
        sub = dataclasses.replace(cfg, channels=1)
        self.channel_model = DONN(sub, laser, device=device)
        self.device = self.channel_model.device
        # the channels' shared gamma (read by ``calibrate_gamma``)
        self.gamma = self.channel_model.gamma

    @property
    def plan(self):
        return self.channel_model.plan

    def param_shapes(self) -> dict:
        c = self.cfg.channels
        return {"phase": {k: (c,) + tuple(s) for k, s in
                          self.channel_model.param_shapes()["phase"].items()}}

    def init(self, generator: torch.Generator) -> dict:
        return _uniform_phases(self.param_shapes(), generator, self.device)

    def stacked_phases(self, params):
        """(L, C, N, N) stack (per segment for a heterogeneous stack)."""
        return self.channel_model.stacked_phases(params)

    def apply(self, params, x: torch.Tensor, rng=None) -> torch.Tensor:
        """x: (..., C, h, w) multi-channel images -> (..., num_classes)."""
        cm = self.channel_model
        if self.cfg.engine == "eager":
            u = torch.stack([
                cm.fields({"phase": {k: v[c] for k, v in
                                     params["phase"].items()}},
                          x[..., c, :, :], rng)[-1]
                for c in range(self.cfg.channels)
            ], dim=-3)  # (..., C, n, n) per-channel output fields
        else:
            u = cm.plan.apply(self.stacked_phases(params), cm.encode(x), rng)
        return channel_readout(u, cm.detector.masks_t, self.cfg.use_pallas)


class SegmentationDONN(_PhaseStack):
    """All-optical image segmentation DONN (paper Fig. 13a).

    Optical skip connection: the field exiting layer ``skip_from`` is split
    off, propagated straight to the detector plane by ``skip_hop`` (a plain
    ``DiffractiveLayer``, cuFFT and a multiply, as the reference builds it
    without ``use_pallas``) and recombined with the main path coherently
    (beam-splitter sum, 1/sqrt(2) each).  The layer norm of the output
    intensity applies only under ``train=True``.
    """

    def __init__(self, cfg: DONNConfig, laser: Optional[Laser] = None,
                 device=None):
        super().__init__(cfg, laser, device)
        self.skip_from = cfg.skip_from
        self.skip_hop = None
        if self.skip_from is not None:
            # the skip hop covers the rest of the distance to the detector
            # plane, on the skip plane's own grid
            z_skip = float(sum(cfg.gap_distances()[self.skip_from + 1:]))
            self.skip_hop = DiffractiveLayer(
                self.layers[self.skip_from].grid,
                z_skip,
                cfg.wavelength,
                method=cfg.resolved_layers()[self.skip_from].approximation,
                band_limit=cfg.band_limit,
                pad=cfg.pad,
            )

    def apply(self, params, x: torch.Tensor, rng=None,
              train: bool = False) -> torch.Tensor:
        """Images (..., h, w) -> per-pixel intensity map (..., n, n)."""
        skip_u = None
        if self.cfg.engine == "eager":
            fields = self.fields(params, x, rng)
            u = fields[-1]
            if self.skip_from is not None:
                skip_u = fields[self.skip_from + 1]
        else:
            if rng is not None:
                raise NotImplementedError(
                    "rng-driven codesign comes with the DSE/codesign slice"
                )
            phis = self.stacked_phases(params)
            u = self.encode(x)
            if self.skip_from is None:
                u = self.plan.forward(phis, u)
            else:
                u = self.plan.forward(phis, u, stop=self.skip_from + 1)
                skip_u = u
                u = self.plan.forward(phis, u, start=self.skip_from + 1)
            u = self.plan.propagate_final(u)
        inten = skip_combine(u, skip_u, self.skip_hop, self.grid)
        if train and self.cfg.layer_norm:
            mean = torch.mean(inten, dim=(-2, -1), keepdim=True)
            var = torch.var(inten, dim=(-2, -1), correction=0, keepdim=True)
            inten = (inten - mean) * torch.rsqrt(var + 1e-6)
        return inten


def skip_combine(u: torch.Tensor, skip_u, skip_hop,
                 out_grid: df.Grid) -> torch.Tensor:
    """Detector-plane intensity of the main field ``u``, recombined first
    with the skip field when there is one: the skip hop, the stitch onto
    the detector grid and the beam-splitter sum ``(u + sk) / sqrt(2)`` in
    complex64.  Training and frozen serving both end here."""
    if skip_u is not None:
        sk = df.resample_field(skip_hop.propagate(skip_u), skip_hop.grid,
                               out_grid)
        u = (u + sk) / math.sqrt(2.0)
    return df.intensity(u)


def build_model(cfg: DONNConfig, laser: Optional[Laser] = None, device=None):
    """Factory used by the configs and the serving CLI."""
    if cfg.segmentation:
        return SegmentationDONN(cfg, laser, device=device)
    if cfg.channels > 1:
        return MultiChannelDONN(cfg, laser, device=device)
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
