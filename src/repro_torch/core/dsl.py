"""LightRidge front-end DSL (paper §3.3, Table 2).

Mirrors the paper's `lr.*` surface: ``lr.laser``, ``lr.layers.diffractlayer``
/ ``diffractlayer_raw`` / ``detector``, ``lr.models.sequential``.  Layer specs
are plain data; ``sequential`` assembles them into a ``DONNConfig`` + model.
A JSON-able ``from_spec`` entry point supports config-file driven builds
(used by the launcher); ``to_spec`` is its inverse, so DSE winners and
heterogeneous architectures round-trip through JSON artifacts.

Layer specs may be *heterogeneous*: per-layer distance, plane size, pixel
size, approximation method and device precision are all free (mixed
SLM + printed-mask stacks, shrinking plane pyramids, ...).  Uniform specs
compile to the classic scalar ``DONNConfig`` (identical plan-cache keys);
mixed specs compile to a ``DONNConfig.layers`` tuple of ``LayerSpec``s and
run on the segmented scan engine.  ``pad`` and ``band_limit`` remain global
knobs (they change the FFT grid protocol, not a layer property).

The port of ``repro.core.dsl``: the spec JSON is shared, so a spec the
JAX package writes builds the same port model and ``to_spec`` writes the
reference's spec.  Models are built on ``device`` (the CUDA card unless
the caller names another), the one argument the port adds.

Example (5-layer hardware-aware classifier, the paper's §5.1 system):

    import repro_torch.core.dsl as lr
    src = lr.laser(wavelength=532e-9)
    layers = [lr.layers.diffractlayer(distance=0.3, pixel_size=36e-6,
                                      size=200, precision=256)
              for _ in range(5)]
    det = lr.layers.detector(num_classes=10, det_size=20)
    model, cfg = lr.models.sequential(layers, det, laser=src)

Mixed-precision, mixed-size stack (SLM front end, printed-mask back end):

    front = [lr.layers.diffractlayer(distance=0.10, size=200, precision=256)
             for _ in range(3)]
    back = [lr.layers.diffractlayer(distance=0.05, size=128, precision=4)
            for _ in range(2)]
    model, cfg = lr.models.sequential(front + back, det, laser=src)
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence

from repro_torch.core import physics
from repro_torch.core.config import DONNConfig, LayerSpec
from repro_torch.core.laser import Laser
from repro_torch.core.models import build_model


def laser(wavelength: float = 532e-9, profile: str = "plane",
          waist: Optional[float] = None, power: float = 1.0) -> Laser:
    return Laser(wavelength=wavelength, profile=profile, waist=waist, power=power)


def _diffractlayer(distance: float = 0.3, pixel_size: float = 36e-6,
                   size: int = 200, approximation: str = "rs",
                   precision: Optional[int] = None, codesign: str = "qat",
                   response_gamma: float = 1.0,
                   pad: bool = False, band_limit: bool = True) -> dict:
    return dict(
        kind="diffract",
        distance=distance,
        pixel_size=pixel_size,
        size=size,
        approximation=approximation,
        precision=precision,
        codesign=codesign if precision else "none",
        response_gamma=response_gamma,
        pad=pad,
        band_limit=band_limit,
    )


def _diffractlayer_raw(**kw) -> dict:
    kw.setdefault("precision", None)
    kw["codesign"] = "none"
    return _diffractlayer(**kw)


def _detector(num_classes: int = 10, det_size: int = 20, layout: str = "grid",
              x_loc=None, y_loc=None, distance: float = 0.3) -> dict:
    return dict(
        kind="detector",
        num_classes=num_classes,
        det_size=det_size,
        layout=layout,
        x_loc=x_loc,
        y_loc=y_loc,
        distance=distance,
    )


# layer-spec keys that may vary per layer vs. the global grid-protocol knobs
_PER_LAYER_KEYS = ("pixel_size", "size", "approximation", "precision",
                   "codesign", "response_gamma")
_GLOBAL_KEYS = ("pad", "band_limit")


def _sequential(layer_specs: Sequence[dict], detector_spec: dict,
                laser: Optional[Laser] = None, device=None, **opts):
    """Assemble layer + detector specs into (model on ``device``,
    DONNConfig).

    ``n`` / ``pixel_size`` in ``opts`` set the detector/system grid
    explicitly; they default to the first layer's plane (the uniform
    convention).  See ``_sequential_config`` for the full option list.
    """
    cfg = _sequential_config(layer_specs, detector_spec, laser=laser, **opts)
    # fail physically invalid specs with a domain error naming the
    # criterion, not a shape/aliasing symptom deep in diffraction.py
    physics.check_config(cfg)
    return build_model(cfg, laser, device=device), cfg


def _sequential_config(layer_specs: Sequence[dict], detector_spec: dict,
                       laser: Optional[Laser] = None, name: str = "donn-dsl",
                       gamma: Optional[float] = None, use_pallas: bool = False,
                       segmentation: bool = False,
                       skip_from: Optional[int] = None,
                       channels: int = 1, input_size: int = 28,
                       engine: str = "scan", scan_unroll: Optional[int] = None,
                       tf_dtype: str = "float32", remat: str = "none",
                       layer_norm: Optional[bool] = None,
                       n: Optional[int] = None,
                       pixel_size: Optional[float] = None) -> DONNConfig:
    """Config-assembly half of ``sequential`` — no model build, no
    validation; shared by the DSL, ``from_spec`` and the lint-time spec
    validator (``spec_to_config``)."""
    if not layer_specs:
        raise ValueError("need at least one diffractive layer")
    first = layer_specs[0]
    for spec in layer_specs[1:]:
        for k in _GLOBAL_KEYS:
            if spec[k] != first[k]:
                raise ValueError(
                    f"heterogeneous {k} across layers unsupported: it is a "
                    "grid-protocol knob, set it once for the whole stack"
                )
    det_n = n if n is not None else first["size"]
    det_pixel = pixel_size if pixel_size is not None else first["pixel_size"]
    # layers are heterogeneous when they differ from each other OR when the
    # (uniform) stack lives off the detector/system grid — the scalar config
    # form cannot express a plane grid != detector grid
    hetero = any(
        spec[k] != first[k]
        for spec in layer_specs[1:] for k in _PER_LAYER_KEYS
    ) or first["size"] != det_n or first["pixel_size"] != det_pixel
    common = dict(
        name=name,
        n=det_n,
        pixel_size=det_pixel,
        wavelength=(laser.wavelength if laser else 532e-9),
        depth=len(layer_specs),
        band_limit=first["band_limit"],
        pad=first["pad"],
        num_classes=detector_spec["num_classes"],
        det_size=detector_spec["det_size"],
        detector_layout=detector_spec["layout"],
        gamma=gamma,
        channels=channels,
        segmentation=segmentation,
        skip_from=skip_from,
        layer_norm=segmentation if layer_norm is None else layer_norm,
        use_pallas=use_pallas,
        input_size=input_size,
        engine=engine,
        scan_unroll=scan_unroll,
        tf_dtype=tf_dtype,
        remat=remat,
    )
    precision = first.get("precision")
    if not hetero:
        distances = ([s["distance"] for s in layer_specs]
                     + [detector_spec["distance"]])
        cfg = DONNConfig(
            distances=tuple(distances),
            approximation=first["approximation"],
            codesign=first["codesign"] if precision else "none",
            device_levels=precision or 256,
            response_gamma=first["response_gamma"],
            **common,
        )
    else:
        layers = tuple(
            LayerSpec(
                distance=s["distance"],
                approximation=s["approximation"],
                codesign=s["codesign"] if s.get("precision") else "none",
                device_levels=s.get("precision") or 256,
                response_gamma=s["response_gamma"],
                size=s["size"],
                pixel_size=s["pixel_size"],
            )
            for s in layer_specs
        )
        cfg = DONNConfig(
            distance=detector_spec["distance"],  # final hop to the detector
            layers=layers,
            approximation=first["approximation"],
            codesign=first["codesign"] if precision else "none",
            device_levels=precision or 256,
            response_gamma=first["response_gamma"],
            **common,
        )
    return cfg


_SEQUENTIAL_OPTS = (
    "name", "gamma", "use_pallas", "segmentation", "skip_from", "channels",
    "input_size", "engine", "scan_unroll", "tf_dtype", "remat",
    "layer_norm", "n", "pixel_size",
)


def spec_to_config(spec: dict) -> DONNConfig:
    """Assemble the ``DONNConfig`` a JSON spec describes — no model build,
    no physics validation (the lint-time / artifact-audit entry point;
    run ``repro_torch.core.physics.validate_config`` on the result)."""
    src = laser(**spec.get("laser", {}))
    layer_specs = [
        _diffractlayer(**{k: v for k, v in s.items() if k != "kind"})
        for s in spec["layers"]
    ]
    det = _detector(**{k: v for k, v in spec["detector"].items() if k != "kind"})
    opts = {k: spec[k] for k in _SEQUENTIAL_OPTS if k in spec}
    return _sequential_config(layer_specs, det, laser=src, **opts)


def from_spec(spec: dict, device=None):
    """Build a model on ``device`` from a JSON-able spec dict: {laser,
    layers, detector,...}.

    Physically invalid specs raise ``PhysicsValidationError`` naming the
    violated criterion before any layer is built.
    """
    src = laser(**spec.get("laser", {}))
    cfg = spec_to_config(spec)
    physics.check_config(cfg)
    return build_model(cfg, src, device=device), cfg


def to_spec(cfg: DONNConfig, laser_: Optional[Laser] = None) -> dict:
    """Inverse of ``from_spec``: DONNConfig -> JSON-able spec dict.

    ``from_spec(to_spec(cfg))`` rebuilds an architecturally identical
    config (same ``canonical()`` form / plan-cache key), uniform or
    heterogeneous — the persistence format for DSE winners and logged
    architectures.
    """
    layers = [
        dict(
            kind="diffract",
            distance=s.distance,
            pixel_size=s.pixel_size,
            size=s.size,
            approximation=s.approximation,
            precision=s.device_levels,
            codesign=s.codesign,
            response_gamma=s.response_gamma,
            pad=cfg.pad,
            band_limit=cfg.band_limit,
        )
        for s in cfg.resolved_layers()
    ]
    laser_spec = (
        dict(wavelength=laser_.wavelength, profile=laser_.profile,
             waist=laser_.waist, power=laser_.power)
        if laser_ is not None else {"wavelength": cfg.wavelength}
    )
    spec = {
        "name": cfg.name,
        "laser": laser_spec,
        "n": cfg.n,  # detector/system grid (may differ from layer planes)
        "pixel_size": cfg.pixel_size,
        "layers": layers,
        "detector": dict(
            kind="detector",
            num_classes=cfg.num_classes,
            det_size=cfg.det_size,
            layout=cfg.detector_layout,
            distance=cfg.gap_distances()[-1],
        ),
        "gamma": cfg.gamma,
        "use_pallas": cfg.use_pallas,
        "segmentation": cfg.segmentation,
        "skip_from": cfg.skip_from,
        "channels": cfg.channels,
        "input_size": cfg.input_size,
        "engine": cfg.engine,
        "scan_unroll": cfg.scan_unroll,
        "tf_dtype": cfg.tf_dtype,
        "remat": cfg.remat,
        "layer_norm": cfg.layer_norm,
    }
    # exported artifacts must be loadable: run the same validator
    # ``from_spec`` applies, so invalid specs fail at export time too
    physics.check_config(cfg)
    return spec


def from_config(cfg: DONNConfig, laser_: Optional[Laser] = None,
                device=None):
    return build_model(cfg, laser_, device=device)


layers = SimpleNamespace(
    diffractlayer=_diffractlayer,
    diffractlayer_raw=_diffractlayer_raw,
    detector=_detector,
)
models = SimpleNamespace(sequential=_sequential)
