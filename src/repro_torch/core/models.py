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
keeps as its own reference path.  Both are differentiable in the phases,
and both take ``rng``, a ``torch.Generator`` for the Gumbel codesign
noise, and consume it identically: the whole stack resolves first, one
draw a layer in layer order (``codesign.py``'s rng contract).

The emulation runtime (the DSE verification path): ``emulate_batch``
scores K candidate geometries (wavelength, pitch, distances, depth) in
one pass, the candidates as one candidate-major field through K1/K2/K3;
``cached_model``/``cached_apply`` reuse one model per config.

Parameters are a plain nested dict in the reference's layout,
``{"phase": {"layer_i": float32 tensor}}`` — (n_i, n_i) per layer (ragged
across a heterogeneous stack), (C, n, n) for the RGB DONN — drawn from an
explicit ``torch.Generator`` (``init``) or carried over from the JAX
package (``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import codesign as cd
from repro_torch.core import diffraction as df
from repro_torch.core import physics
from repro_torch.core import propagation as pp
from repro_torch.core.cache import lru_get, lru_put
from repro_torch.core.config import DONNConfig
from repro_torch.core.laser import Laser, data_to_cplex
from repro_torch.core.layers import Detector, DiffractiveLayer
from repro_torch.core.propagation import plan_from_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def channel_readout(u: torch.Tensor, masks: torch.Tensor,
                    use_pallas: bool, dim: int = -3) -> torch.Tensor:
    """Multi-channel detector accumulation, shared by every path.

    (..., C, n, n) per-channel output fields -> (..., num_classes): the
    incoherent channel sum pooled over the per-class detector regions,
    through K3 under ``use_pallas`` or one contraction otherwise.  Training
    (``MultiChannelDONN.apply``, both engines), batched emulation
    (``emulate_batch``, whose (K, C, B, n, n) field has its channels at
    ``dim=1``) and serving (``repro_torch.runtime.inference``) all read
    out here.
    """
    if use_pallas:
        return kops.channel_intensity_readout(u, masks, dim)
    return torch.einsum("...dhw,chw->...c", df.intensity(u.movedim(dim, -3)),
                        masks)


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

    def param_specs(self) -> dict:
        """One ``ParamSpec`` a layer, rows and columns named for the
        sharding rules (``("field_h", "field_w")``)."""
        return {"phase": {f"layer_{i}": l.param_spec()
                          for i, l in enumerate(self.layers)}}

    def init(self, generator: torch.Generator) -> dict:
        return _uniform_phases(self.param_shapes(), generator, self.device)

    # --- forward ---
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return data_to_cplex(x, self.in_grid.n) * self.source_t

    def resolve(self, params, rng=None) -> list:
        """Each layer's device phase (``DiffractiveLayer.phase``), in layer
        order: one draw a layer from ``rng``."""
        return [layer.phase(params["phase"][f"layer_{i}"], rng)
                for i, layer in enumerate(self.layers)]

    def fields(self, params, x: torch.Tensor, rng=None) -> list:
        """All intermediate fields of the eager engine (lr.model.prop_view):
        the encoded input, each layer's output and the detector plane."""
        return self._run(self.resolve(params, rng), x)

    def _run(self, phases: list, x: torch.Tensor) -> list:
        """The eager engine on resolved phases (``resolve``)."""
        u = self.encode(x)
        out = [u]
        cur = self.in_grid
        for layer, phi in zip(self.layers, phases):
            u = df.resample_field(u, cur, layer.grid)  # no-op on equal grids
            u = layer.apply_phase(phi, layer.propagate(u))
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

    def param_specs(self) -> dict:
        """The channel model's specs with a leading ``"channel"`` axis."""
        c = self.cfg.channels
        return {"phase": {
            k: dataclasses.replace(s, shape=(c,) + tuple(s.shape),
                                   logical_axes=("channel",) + s.logical_axes)
            for k, s in self.channel_model.param_specs()["phase"].items()}}

    def init(self, generator: torch.Generator) -> dict:
        return _uniform_phases(self.param_shapes(), generator, self.device)

    def stacked_phases(self, params):
        """(L, C, N, N) stack (per segment for a heterogeneous stack)."""
        return self.channel_model.stacked_phases(params)

    def apply(self, params, x: torch.Tensor, rng=None) -> torch.Tensor:
        """x: (..., C, h, w) multi-channel images -> (..., num_classes).
        The channels share each layer's draw from ``rng``."""
        cm = self.channel_model
        if self.cfg.engine == "eager":
            phases = cm.resolve(params, rng)  # (C, n, n) a layer
            u = torch.stack([
                cm._run([p[c] for p in phases], x[..., c, :, :])[-1]
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
        """Images (..., h, w) -> per-pixel intensity map (..., n, n).  The
        stack resolves its codesign once (one draw a layer from ``rng``)
        and both halves of the skip split run on it, as the reference's two
        forwards on one key stack do."""
        skip_u = None
        if self.cfg.engine == "eager":
            fields = self.fields(params, x, rng)
            u = fields[-1]
            if self.skip_from is not None:
                skip_u = fields[self.skip_from + 1]
        else:
            phis = self.plan.codesign_stack(self.stacked_phases(params), rng)
            u = self.encode(x)
            if self.skip_from is None:
                u = self.plan.forward(phis, u, resolved=True)
            else:
                u = self.plan.forward(phis, u, stop=self.skip_from + 1,
                                      resolved=True)
                skip_u = u
                u = self.plan.forward(phis, u, start=self.skip_from + 1,
                                      resolved=True)
            u = self.plan.propagate_final(u)
        return layer_norm(skip_combine(u, skip_u, self.skip_hop, self.grid),
                          train and self.cfg.layer_norm)


def layer_norm(inten: torch.Tensor, on: bool) -> torch.Tensor:
    """The segmentation DONN's train-time layer norm over each map (a
    no-op when ``on`` is False): ``SegmentationDONN.apply`` and
    ``emulate_batch`` both end here."""
    if not on:
        return inten
    mean = torch.mean(inten, dim=(-2, -1), keepdim=True)
    var = torch.var(inten, dim=(-2, -1), correction=0, keepdim=True)
    return (inten - mean) * torch.rsqrt(var + 1e-6)


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


# --------------------------------------------------------------------------
# Emulation runtime (the DSE verification path)
# --------------------------------------------------------------------------
# The reference memoizes models, plans, batched inputs and AOT-compiled
# executables (``propagation.cached_executable``).  Eager PyTorch compiles
# nothing, so the port has no executable cache: ``cached_apply`` is the
# cached model's ``apply``, and what stays memoized is what costs host work
# to rebuild — models, plans and the stacked per-candidate device inputs.
_MODEL_CACHE: dict = {}
_MODEL_CACHE_MAX = 64
_MODEL_STATS = {"hits": 0, "misses": 0}

# geometry knobs free to vary across one emulate_batch candidate set; every
# other config field is an architecture static shared by the batch.  depth
# rides along via depth-padded + masked candidate stacks.
_GEOMETRY_FIELDS = ("name", "wavelength", "pixel_size", "distance",
                    "distances", "depth")


def _shared_statics_key(cfg: DONNConfig) -> tuple:
    d = dict(config_static_key(cfg))
    for f in _GEOMETRY_FIELDS:
        d.pop(f, None)
    return tuple(sorted(d.items()))


def clear_emulation_caches() -> None:
    """Clear the model + batched-input memos and the plan cache."""
    _MODEL_CACHE.clear()
    _MODEL_STATS.update(hits=0, misses=0)
    _BATCH_INPUT_CACHE.clear()
    _BATCH_INPUT_STATS.update(hits=0, misses=0, device_builds=0)
    pp.clear_plan_cache()


def model_cache_key(model) -> Optional[tuple]:
    """Cache identity of a model, or None when not keyable: a model's
    numerics are a pure function of its config when it exposes ``cfg`` and
    was built with the default laser (``Laser`` is a frozen dataclass, so
    default-equivalent explicit lasers compare equal)."""
    cfg = getattr(model, "cfg", None)
    if cfg is None:
        return None
    inner = getattr(model, "channel_model", model)  # MultiChannelDONN
    if getattr(inner, "laser", None) != Laser(wavelength=cfg.wavelength):
        return None
    return config_static_key(cfg)


def cached_model(cfg: DONNConfig, laser: Optional[Laser] = None,
                 device=None):
    """Memoized ``build_model`` on ``device`` (default laser only): DSE
    sweeps and repeated emulations reuse one layer stack + detector per
    config and device.  Models hold no parameters, so sharing is safe."""
    if laser is not None:
        return build_model(cfg, laser, device=device)
    dev = resolve_device(device)
    key = (config_static_key(cfg), str(dev))
    model = lru_get(_MODEL_CACHE, key, _MODEL_STATS)
    if model is None:
        model = build_model(cfg, device=dev)
        lru_put(_MODEL_CACHE, key, model, _MODEL_CACHE_MAX)
    return model


def cached_apply(cfg: DONNConfig, device=None):
    """``f(params, x, rng=None)``: the cached model's ``apply``, inputs
    (numpy or tensors) moved to its device as float32."""
    model = cached_model(cfg, device=device)

    def run(params, x, rng=None):
        x = torch.as_tensor(x).to(model.device, torch.float32)
        return model.apply(params, x, rng)

    return run


def _stack_phases(params, depth: int,
                  pad_to: Optional[int] = None) -> torch.Tensor:
    """(L, ...) phase stack; zero-padded along L to ``pad_to`` if given."""
    phis = torch.stack([params["phase"][f"layer_{i}"] for i in range(depth)])
    if pad_to is not None and pad_to > depth:
        pad = phis.new_zeros((pad_to - depth,) + tuple(phis.shape[1:]))
        phis = torch.cat([phis, pad])
    return phis


# candidate-set geometry -> stacked device inputs (TF planes, sources, skip
# planes).  They are deterministic in the geometry tuple, so warm
# emulate_batch calls skip the rebuild.  ``device_builds`` counts the misses
# whose planes ``transfer_planes_batched`` built; the rest (fraunhofer sets)
# were built on the host.
_BATCH_INPUT_CACHE: dict = {}
_BATCH_INPUT_CACHE_MAX = 32
_BATCH_INPUT_STATS = {"hits": 0, "misses": 0, "device_builds": 0}


def _batched_inputs(cfgs, base, gamma: float, template, has_skip: bool,
                    dev: torch.device):
    """Stacked transfer planes, sources and skip planes on ``dev``
    (memoized): TF planes layer-major, (L+1, K, N, N) each in the template
    plan's own convention (``template._plane_keys``: polar under
    ``use_pallas``, cartesian otherwise; bf16 storage under that
    ``tf_dtype``), so layer i's planes are one contiguous (K, N, N) slab;
    sources and skip planes (K, N, N).

    A candidate set's planes are built on ``dev`` in one launch of
    ``kops.transfer_planes_batched``, with no plan and no TF-cache entry a
    candidate: a sweep never reuses a geometry, so caching its planes
    would only churn the cache that single-model plans share.  Single
    plans (``PropagationPlan``) still build their planes with numpy,
    through that cache.  Candidates of unequal depth are padded to the
    deepest one (``template.depth``): see ``_geometry_table``.
    """
    with tracing.span("dse.inputs") as s:
        key = ("emulate_inputs",
               tuple(pp.plan_cache_key(c, gamma) for c in cfgs),
               base.skip_from if has_skip else None, str(dev))
        hit = lru_get(_BATCH_INPUT_CACHE, key, _BATCH_INPUT_STATS)
        s.set(hit=hit is not None)
        if hit is not None:
            return hit
        entry = _build_batched_inputs(cfgs, base, template, has_skip, dev)
    lru_put(_BATCH_INPUT_CACHE, key, entry, _BATCH_INPUT_CACHE_MAX)
    return entry


def _geometry_table(cfgs, depth: int, skip_from: Optional[int]) -> list:
    """One row a candidate: pixel size, wavelength, then its gaps padded
    to ``depth`` + 1 and, with a skip, the skip hop's distance.

    Rows [0, d) are a depth-d candidate's layer gaps and row ``depth`` its
    final hop.  Dummy rows (the final gap again: any finite plane works,
    the layer mask makes them identity hops) go *between* the layer gaps
    and the final hop, so every candidate's final plane sits at the shared
    index ``depth``.  The skip hop covers the rest of the distance to the
    detector plane from layer ``skip_from``.
    """
    rows = []
    for c in cfgs:
        gaps = c.gap_distances()
        row = [float(c.pixel_size), float(c.wavelength), *gaps[:c.depth],
               *(gaps[c.depth],) * (depth + 1 - c.depth)]
        if skip_from is not None:
            row.append(float(sum(gaps[skip_from + 1:])))
        rows.append(row)
    return rows


def _host_planes(rows, base, keys, pad: bool, dev: torch.device):
    """The planes of ``_geometry_table``'s rows built on the host from the
    TF cache, laid out as ``kops.transfer_planes_batched`` lays them out
    (row g*K + k: candidate k's gap g).  For fraunhofer sets, whose
    far-field factor the kernel does not build."""
    planes = [pp.transfer_planes(df.Grid(base.n, row[0]), row[2 + g],
                                 row[1], base.approximation, base.band_limit,
                                 pad)
              for g in range(len(rows[0]) - 2) for row in rows]
    return tuple(torch.from_numpy(np.stack([p[k] for p in planes])).to(dev)
                 for k in keys)


def _build_batched_inputs(cfgs, base, template, has_skip: bool,
                          dev: torch.device):
    """What ``_batched_inputs`` memoizes.  Every candidate is validated
    first (``physics.check_config``: an invalid geometry raises, a soft
    criterion warns), as a plan build would validate it."""
    K, L = len(cfgs), template.depth
    with tracing.span("dse.inputs.geometry"):
        for c in cfgs:
            physics.check_config(c)
        rows = _geometry_table(cfgs, L, base.skip_from if has_skip else None)
        # the far-field factor is not a transfer function: the host builds
        # it, as a single plan does
        on_dev = base.approximation != df.FRAUNHOFER
        if on_dev:
            table = torch.tensor(rows, dtype=torch.float64).to(dev)
    with tracing.span("dse.inputs.planes"):
        if on_dev:
            n = 2 * base.n if template.pad else base.n
            a, b = kops.transfer_planes_batched(
                table, n, base.approximation, base.band_limit,
                polar=template.use_pallas)
            _BATCH_INPUT_STATS["device_builds"] += 1
        else:
            a, b = _host_planes(rows, base, template._plane_keys,
                                template.pad, dev)
        hops = (L + 1) * K
        tfs = tuple(p[:hops].view((L + 1, K) + tuple(p.shape[1:]))
                    for p in (a, b))
        skip_pair = tuple(p[hops:] for p in (a, b)) if has_skip else None
        if base.tf_dtype != "float32":  # storage only: consumers upcast
            tfs = tuple(t.to(torch.bfloat16) for t in tfs)
            if skip_pair is not None:  # own copies: the f32 build is freed
                skip_pair = tuple(p.clone() for p in skip_pair)
    with tracing.span("dse.inputs.sources"):
        # the default laser's plane wave (``Laser.field``): sqrt(power)
        # everywhere, for every candidate
        sources = torch.full((K, base.n, base.n), math.sqrt(Laser().power),
                             dtype=torch.complex64, device=dev)
    return tfs, sources, skip_pair


def emulate_batch(cfgs: Sequence[DONNConfig], params, x, rng=None,
                  train: bool = False, device=None) -> torch.Tensor:
    """Emulate K candidate DONN configs in one pass on ``device``.

    The DSE verification primitive: all cfgs must share architecture
    statics (n, channels, detector geometry, engine flags), while
    per-candidate *geometry* — wavelength, pixel_size, distance(s), and
    **depth** — is free.  The K candidates run as one candidate-major
    field, (K, B, N, N) ((K, C, B, N, N) for RGB), with layer-major
    per-candidate planes (``_batched_inputs``): every kernel call reads it
    as plane-major slabs with no transpose (``PropagationPlan.forward``,
    ``lead=True``), K3 reads the K*B (K*C*B) rows against the shared
    masks, and one call replaces K ``build_model(cfg).apply`` calls.

    Ragged-depth candidate sets are depth-padded to the deepest candidate
    and masked: padded layers pass the carry through, so a 2-layer and a
    5-layer architecture score in the same pass (per-candidate params
    required).

    params: one tree shared by every candidate, or a sequence of K trees
    (required when depths differ), on ``device``.  x: one shared input
    batch.  rng: one ``torch.Generator``; the candidates draw in turn,
    each over the padded depth, one draw a layer (the reference splits
    one key per candidate, each over the padded depth: the same order).

    Returns the stacked (K, ...) outputs of ``build_model(cfg).apply`` per
    candidate: per-class intensities for classifiers, intensity maps for
    segmentation (``train=True`` applies the train-time layer norm).
    """
    with tracing.span("dse.emulate", K=len(cfgs), B=len(x)):
        return _emulate_batch(cfgs, params, x, rng, train, device)


def _emulate_batch(cfgs, params, x, rng, train: bool, device):
    with tracing.span("dse.prepare"):
        dev = resolve_device(device)
        cfgs = [c.canonical() for c in cfgs]
        if not cfgs:
            raise ValueError("emulate_batch needs at least one candidate")
        for c in cfgs:
            if c.layers is not None:
                raise ValueError(
                    "emulate_batch candidates must be per-candidate-uniform "
                    f"stacks; {c.name!r} has heterogeneous per-layer specs "
                    "(cfg.layers), which cannot share one batched pass yet"
                )
        base = cfgs[0]
        skey = _shared_statics_key(base)
        for c in cfgs[1:]:
            if _shared_statics_key(c) != skey:
                raise ValueError(
                    "emulate_batch candidates must share all non-geometry "
                    "statics (n, channels, detector, engine flags); "
                    f"{c.name!r} differs from {base.name!r}"
                )
        K = len(cfgs)
        n = base.n
        gamma = 1.0 if base.gamma is None else float(base.gamma)
        depths = [c.depth for c in cfgs]
        mixed_depth = len(set(depths)) > 1
        # the template plan runs every candidate; its depth is the padded
        # depth (shallower candidates mask their tail)
        template = pp.plan_from_config(cfgs[int(np.argmax(depths))], gamma)
        L = template.depth
        has_skip = base.segmentation and base.skip_from is not None
        if has_skip and base.skip_from >= min(depths):
            raise ValueError(
                f"skip_from={base.skip_from} must precede the shallowest "
                f"candidate (min depth {min(depths)})"
            )
    tfs, sources, skip_pair = _batched_inputs(cfgs, base, gamma, template,
                                              has_skip, dev)
    with tracing.span("dse.codesign"):
        if isinstance(params, (list, tuple)):
            if len(params) != K:
                raise ValueError(
                    f"got {len(params)} params for {K} candidates")
            eff = template.codesign_batch(torch.stack([
                _stack_phases(p, c.depth, pad_to=L)
                for p, c in zip(params, cfgs)
            ]), rng)
        else:
            if mixed_depth:
                raise ValueError(
                    "mixed-depth candidate sets need per-candidate params "
                    "(one tree per depth); got a single shared tree"
                )
            one = _stack_phases(params, base.depth)
            # one deterministic response serves every candidate
            if rng is None:
                eff = template.codesign_stack(one).unsqueeze(1).expand(
                    (L, K) + tuple(one.shape[1:]))
            else:
                eff = template.codesign_batch(
                    one.expand((K,) + tuple(one.shape)), rng)
        mask = None
        if mixed_depth:
            # (L, K) layer-validity mask: padded tail layers pass the carry
            mask = torch.from_numpy(np.arange(L)[:, None]
                                    < np.asarray(depths)[None, :]).to(dev)

    with tracing.span("dse.upload_x"):
        u0 = data_to_cplex(torch.as_tensor(x).to(dev, torch.float32), n)
    family = ("seg" if base.segmentation
              else "multi" if base.channels > 1 else "cls")
    if family == "multi":  # (B, C, n, n) -> (C, B, n, n): channels lead
        u0 = u0.movedim(-3, 0)
    with tracing.span("dse.forward"):
        u = sources.reshape((K,) + (1,) * (u0.dim() - 2) + (n, n)) * u0
        kw = dict(tfs=tfs, mask=mask, resolved=True, lead=True)
        if family != "seg":
            u = template.apply(eff, u, **kw)
            if family == "multi":
                det = cached_model(base, device=dev).channel_model.detector
                return channel_readout(u, det.masks_t, base.use_pallas,
                                       dim=1)
            return cached_model(base, device=dev).detector(u)
        if has_skip:
            u = template.forward(eff, u, stop=base.skip_from + 1, **kw)
            skip_u = u
            u = template.forward(eff, u, start=base.skip_from + 1, **kw)
            u = template.propagate_final(u, tfs=tfs, lead=True)
            u = (u + template._hop(skip_u, skip_pair, lead=True)) \
                / math.sqrt(2.0)
        else:
            u = template.apply(eff, u, **kw)
        return layer_norm(df.intensity(u), train and base.layer_norm)
