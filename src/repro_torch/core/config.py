"""Configuration dataclasses for DONN systems (the paper's architectures).

A verbatim copy of ``repro.core.config``: the port keeps its own copy so it
imports nothing of the JAX package, and the field list is pinned equal to
the reference's by tests/test_torch_geometry.py.  ``scan_unroll`` steers
only JAX machinery and has no effect in the port; ``remat`` maps to
``torch.utils.checkpoint`` (``propagation.PropagationPlan``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

_METHODS = ("rs", "fresnel", "fraunhofer")
_CODESIGN_MODES = ("none", "qat", "gumbel", "gumbel_hard", "ptq")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Per-layer architecture description (heterogeneous DONN stacks).

    Every field except ``distance`` may be ``None``, meaning "inherit the
    config-level scalar" — a ``DONNConfig`` whose ``layers`` all resolve to
    the config scalars is *canonically identical* to the uniform config
    (same plan-cache key, same compiled program).

    - ``distance``: propagation gap *into* this layer (from the previous
      plane — the source plane for layer 0) [m].
    - ``approximation``: rs | fresnel | fraunhofer.
    - ``codesign`` / ``device_levels`` / ``response_gamma``: per-layer
      fabrication device (e.g. a 256-level SLM front stack driving 4-level
      printed-mask back layers, trained jointly).
    - ``size`` / ``pixel_size``: per-layer plane geometry; fields are
      resampled between planes whose grids differ.
    """

    distance: float = 0.30
    approximation: Optional[str] = None
    codesign: Optional[str] = None
    device_levels: Optional[int] = None
    response_gamma: Optional[float] = None
    size: Optional[int] = None
    pixel_size: Optional[float] = None

    def __post_init__(self):
        if self.approximation is not None and self.approximation not in _METHODS:
            raise ValueError(
                f"LayerSpec.approximation must be one of {_METHODS}, "
                f"got {self.approximation!r}"
            )
        if self.codesign is not None and self.codesign not in _CODESIGN_MODES:
            raise ValueError(
                f"LayerSpec.codesign must be one of {_CODESIGN_MODES}, "
                f"got {self.codesign!r}"
            )

    def resolve(self, cfg: "DONNConfig") -> "LayerSpec":
        """Fill inherited (None) fields from the config scalars."""
        return LayerSpec(
            distance=float(self.distance),
            approximation=self.approximation or cfg.approximation,
            codesign=self.codesign if self.codesign is not None else cfg.codesign,
            device_levels=(self.device_levels if self.device_levels is not None
                           else cfg.device_levels),
            response_gamma=(float(self.response_gamma)
                            if self.response_gamma is not None
                            else float(cfg.response_gamma)),
            size=self.size if self.size is not None else cfg.n,
            pixel_size=(float(self.pixel_size) if self.pixel_size is not None
                        else float(cfg.pixel_size)),
        )


@dataclasses.dataclass(frozen=True)
class DONNConfig:
    """Full architectural + fabrication description of a DONN system.

    Mirrors the knobs exposed by the LightRidge DSL (Table 2): system size,
    diffraction unit size, wavelength, per-gap distances, approximation
    method, device precision, detector geometry, codesign mode.

    Heterogeneous stacks are described by ``layers`` — one ``LayerSpec``
    per diffractive layer, each overriding the config scalars per layer
    (plane size, pixel size, approximation, codesign device, distance).
    With ``layers`` set, ``distance`` is the final layer -> detector gap
    and ``distances`` must be None.  A ``layers`` tuple that resolves to
    the uniform scalars canonicalizes back to the scalar form
    (``canonical()``) and shares its plan cache entry.
    """

    name: str = "donn"
    n: int = 200  # system size / resolution per side
    pixel_size: float = 36e-6  # diffraction unit size [m]
    wavelength: float = 532e-9  # [m]
    distance: float = 0.30  # uniform inter-plane distance [m]
    distances: Optional[Sequence[float]] = None  # per-gap override (depth+1 gaps)
    depth: int = 3  # number of diffractive layers
    approximation: str = "rs"  # rs | fresnel | fraunhofer
    band_limit: bool = True
    pad: bool = False  # 2x zero-padding for linear convolution
    # --- detector ---
    num_classes: int = 10
    det_size: int = 20  # detector region side [pixels]
    detector_layout: str = "grid"
    # --- training physics ---
    gamma: Optional[float] = None  # complex-valued regularization factor
    # --- hardware codesign ---
    codesign: str = "none"  # none | qat | gumbel | gumbel_hard | ptq
    device_levels: int = 256
    response_gamma: float = 1.0
    # --- advanced architectures ---
    channels: int = 1  # multi-channel (RGB) DONN
    segmentation: bool = False
    skip_from: Optional[int] = None  # optical-skip source layer index
    layer_norm: bool = False  # train-time LN before detector (segmentation)
    # --- heterogeneous per-layer architecture ---
    layers: Optional[Sequence[LayerSpec]] = None  # per-layer overrides
    # --- runtime ---
    use_pallas: bool = False  # Pallas kernels for modulation/readout
    engine: str = "scan"  # "scan" (fused PropagationPlan) | "eager" (per-layer loop)
    input_size: int = 28  # native input image side (embedded/upsampled to n)
    # scan-engine steady-state tuning: unroll factor for the layer scan
    # (None = depth heuristic, see propagation.default_scan_unroll)
    scan_unroll: Optional[int] = None
    # TF-plane storage dtype: "float32" (reference) | "bfloat16" (half the
    # constant memory; accumulation stays f32, agreement tolerance loosens)
    tf_dtype: str = "float32"
    # Rematerialization policy for the layer scan (training memory knob):
    #   "none"    — store every layer's activations for the backward pass
    #               (fastest, highest memory; the default);
    #   "layer"   — jax.checkpoint the scan body, so the backward pass
    #               recomputes each layer's FFT chain from its carry
    #               (activation memory drops from O(depth) fields to O(1)
    #               per scan segment — the deep/large-plane training knob);
    #   "segment" — jax.checkpoint each fused scan segment as a whole
    #               (per-segment boundaries only; for uniform stacks this
    #               checkpoints the entire layer stack).
    remat: str = "none"

    def __post_init__(self):
        if self.engine not in ("scan", "eager"):
            raise ValueError(
                f"engine must be 'scan' or 'eager', got {self.engine!r}"
            )
        if self.remat not in ("none", "layer", "segment"):
            raise ValueError(
                f"remat must be 'none', 'layer' or 'segment', "
                f"got {self.remat!r}"
            )
        if self.tf_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"tf_dtype must be 'float32' or 'bfloat16', got {self.tf_dtype!r}"
            )
        if self.scan_unroll is not None and self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        if self.distances is not None and len(self.distances) != self.depth + 1:
            raise ValueError(
                f"distances must have depth+1={self.depth + 1} entries "
                f"(source->L1, inter-layer gaps, L_last->detector); got "
                f"{len(self.distances)}"
            )
        if self.layers is not None:
            if self.distances is not None:
                raise ValueError(
                    "layers and distances are mutually exclusive: per-layer "
                    "gaps live in LayerSpec.distance and `distance` is the "
                    "final layer->detector gap"
                )
            if len(self.layers) != self.depth:
                raise ValueError(
                    f"layers must have depth={self.depth} entries, got "
                    f"{len(self.layers)}"
                )
            if not all(isinstance(l, LayerSpec) for l in self.layers):
                raise ValueError("layers entries must be LayerSpec instances")
            # normalize to a tuple so frozen configs hash/compare by value
            object.__setattr__(self, "layers", tuple(self.layers))

    def gap_distances(self) -> tuple:
        """depth+1 propagation gaps: source->L1, L_i->L_{i+1}, L_last->det."""
        if self.layers is not None:
            return tuple(float(l.distance) for l in self.layers) + (
                float(self.distance),
            )
        if self.distances is not None:
            return tuple(float(d) for d in self.distances)
        return (float(self.distance),) * (self.depth + 1)

    def resolved_layers(self) -> tuple:
        """Fully-resolved per-layer specs (inherits filled from scalars)."""
        gaps = self.gap_distances()
        if self.layers is not None:
            return tuple(l.resolve(self) for l in self.layers)
        return tuple(
            LayerSpec(distance=gaps[i]).resolve(self) for i in range(self.depth)
        )

    def canonical(self) -> "DONNConfig":
        """Normal form: uniform ``layers`` fold back into the scalar fields.

        A config whose per-layer specs all resolve to the config scalars is
        the *same architecture* as the scalar config — ``canonical()`` maps
        both spellings to one value so plan/model/executable caches key
        identically.  Heterogeneous configs normalize their ``layers`` to
        the fully-resolved form (inherited Nones filled in).
        """
        if self.layers is None:
            return self
        resolved = self.resolved_layers()
        common = dataclasses.replace(resolved[0], distance=0.0)
        if (all(dataclasses.replace(l, distance=0.0) == common
                for l in resolved)
                and common.size == self.n
                and common.pixel_size == float(self.pixel_size)):
            # every layer equals every other (up to distance) and lives on
            # the detector/system grid: this IS the scalar architecture —
            # fold onto the layers' common values (not the possibly
            # different inheritance scalars)
            return dataclasses.replace(
                self,
                layers=None,
                distances=self.gap_distances(),
                approximation=common.approximation,
                codesign=common.codesign,
                device_levels=common.device_levels,
                response_gamma=common.response_gamma,
            )
        # once layers are fully resolved, the per-layer inheritance scalars
        # are shadowed — reset them so equivalent spellings key identically
        shadowed = dict(approximation="rs", codesign="none",
                        device_levels=256, response_gamma=1.0)
        if resolved == self.layers and all(
            getattr(self, k) == v for k, v in shadowed.items()
        ):
            return self
        return dataclasses.replace(self, layers=resolved, **shadowed)

    def is_heterogeneous(self) -> bool:
        return self.canonical().layers is not None
