"""Physics-validity validation for DONN specs (shared lint/build-time).

A copy of ``repro.core.physics`` (the port imports nothing of the JAX
package); tests/test_torch_geometry.py holds both to the same criteria.

One validator, two consumers:

- **build time**: ``plan_from_config`` / ``dsl.from_spec`` call
  ``check_config`` on a cache miss, so a physically invalid spec fails
  with a structured :class:`PhysicsValidationError` naming the violated
  criterion instead of a shape error (or a silently aliased kernel) deep
  in ``diffraction.py``;
- **lint time**: ``tools/lightlint`` rule LR201/LR202 statically
  evaluates ``DONNConfig(...)`` call sites and JSON ``to_spec`` artifacts
  and runs the same ``validate_config`` — the criteria can never drift
  between the linter and the runtime because they are one function.

Criteria (severity in brackets):

- ``geometry`` [error] — positive plane sizes / pitches / wavelength,
  non-negative gaps (Fraunhofer needs strictly positive ``z``).
- ``sampling-aliasing`` [error] — the transfer-function sampling
  criterion for rs/fresnel hops *without* band-limiting: H(fx, fy) is
  adequately sampled only up to the critical distance
  ``z_crit = N_eff * dx^2 / wavelength`` (``N_eff = 2N`` under ``pad``);
  beyond it the angular spectrum wraps and the kernel aliases
  (Matsushima & Shimobaba 2009).  With ``band_limit=True`` the mask
  suppresses the wrapped orders, so the criterion does not apply.
- ``device-levels`` [error] — codesign quantization needs at least 2
  phase levels and at most 65536 (the ``to_slm`` uint16 export domain).
- ``stitch-undersample`` [error] — a heterogeneous stitch that resamples
  a field onto a grid more than 2x coarser undersamples it (bilinear
  resampling has no anti-alias filter); finer-or-equal and mildly
  coarser stitches are fine.
- ``fraunhofer-far-field`` [warning] — Fraunhofer hops want Fresnel
  number ``F = a^2/(wavelength*z) <= 1`` (``a`` = half-aperture); in the
  near field the single-FFT far-field pattern is not the physical field.
- ``fresnel-near-field`` [warning] — the parabolic-wavefront expansion
  needs ``z^3 >> pi*a^4/(4*wavelength)``; warn below the cube root.
- ``band-limit-collapse`` [warning] — a band-limited hop whose
  ``f_limit`` falls under 10% of grid Nyquist keeps almost no spectrum:
  the distance/pitch pair is so aggressive the mask erases the field.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Sequence

ERROR = "error"
WARNING = "warning"

# ``to_slm`` exports uint8 phase indices for <=256 levels, uint16 above:
# 65536 levels is the largest device response domain it can address.
MAX_DEVICE_LEVELS = 65536
MIN_DEVICE_LEVELS = 2

# stitches coarser than this pitch ratio alias (no anti-alias filter in
# the bilinear resample operator)
MAX_STITCH_PITCH_RATIO = 2.0

# band-limit mask keeping under this fraction of grid Nyquist erases
# nearly the whole angular spectrum
BAND_LIMIT_COLLAPSE_FRAC = 0.1


@dataclasses.dataclass(frozen=True)
class PhysicsViolation:
    """One violated physics criterion, locatable to a hop in the stack."""

    criterion: str  # e.g. "sampling-aliasing"
    severity: str  # ERROR | WARNING
    where: str  # e.g. "layer 2", "detector hop"
    message: str  # human-readable, includes the numbers

    def __str__(self):
        return f"[{self.criterion}] {self.where}: {self.message}"


class PhysicsValidationError(ValueError):
    """A DONN spec violates hard physics-validity criteria.

    ``violations`` carries the structured list; the message names every
    violated criterion so callers (and users loading JSON specs) see the
    domain error, not a downstream shape/aliasing symptom.
    """

    def __init__(self, violations: Sequence[PhysicsViolation]):
        self.violations = tuple(violations)
        crits = sorted({v.criterion for v in self.violations})
        detail = "; ".join(str(v) for v in self.violations)
        super().__init__(
            f"physically invalid DONN spec ({', '.join(crits)}): {detail}"
        )


class PhysicsWarning(UserWarning):
    """Soft physics-validity criterion violated (approximation regime)."""


def critical_distance(n: int, pixel_size: float, wavelength: float,
                      pad: bool = False) -> float:
    """Max distance before the unmasked TF aliases: ``N_eff*dx^2/lambda``."""
    n_eff = 2 * n if pad else n
    return n_eff * pixel_size * pixel_size / wavelength


def fresnel_number(n: int, pixel_size: float, z: float,
                   wavelength: float) -> float:
    """``a^2/(lambda*z)`` with ``a`` = half-aperture (regime check)."""
    a = n * pixel_size / 2.0
    return a * a / (wavelength * z)


def band_limit_frequency(n: int, pixel_size: float, z: float,
                         wavelength: float, pad: bool = False) -> float:
    """Matsushima & Shimobaba band-limit ``f_limit`` for one hop [1/m]."""
    n_eff = 2 * n if pad else n
    s = n_eff * pixel_size
    return 1.0 / (wavelength * math.sqrt((2.0 * z / s) ** 2 + 1.0))


def _check_hop(out, n: int, pixel_size: float, z: float, wavelength: float,
               method: str, band_limit: bool, pad: bool, where: str):
    """Validate one free-space hop computed on an (n, pixel_size) grid."""
    if method == "fraunhofer":
        if z <= 0.0:
            out.append(PhysicsViolation(
                "geometry", ERROR, where,
                f"fraunhofer propagation needs z > 0, got {z:g} m"))
            return
        fn = fresnel_number(n, pixel_size, z, wavelength)
        if fn > 1.0:
            out.append(PhysicsViolation(
                "fraunhofer-far-field", WARNING, where,
                f"Fresnel number {fn:.3g} > 1 at z={z:g} m: the far-field "
                f"(single-FFT) pattern is not valid this close; use rs or "
                f"fresnel, or z >= {n * pixel_size / 2.0:.3g}**2/lambda = "
                f"{(n * pixel_size / 2.0) ** 2 / wavelength:.3g} m"))
        return
    if z < 0.0:
        out.append(PhysicsViolation(
            "geometry", ERROR, where,
            f"propagation distance must be >= 0, got {z:g} m"))
        return
    if z == 0.0:
        return  # identity hop: H == 1, every criterion trivially holds
    z_crit = critical_distance(n, pixel_size, wavelength, pad)
    if not band_limit and z > z_crit:
        out.append(PhysicsViolation(
            "sampling-aliasing", ERROR, where,
            f"z={z:g} m exceeds the TF sampling limit z_crit="
            f"{z_crit:.4g} m for n={n}, dx={pixel_size:g} m, "
            f"lambda={wavelength:g} m{' (padded)' if pad else ''}: the "
            f"angular-spectrum kernel aliases; enable band_limit, reduce "
            f"z, or refine the grid"))
    if band_limit:
        f_limit = band_limit_frequency(n, pixel_size, z, wavelength, pad)
        f_nyq = 1.0 / (2.0 * pixel_size)
        if f_limit < BAND_LIMIT_COLLAPSE_FRAC * f_nyq:
            out.append(PhysicsViolation(
                "band-limit-collapse", WARNING, where,
                f"band limit f_limit={f_limit:.4g}/m is below "
                f"{BAND_LIMIT_COLLAPSE_FRAC:.0%} of grid Nyquist "
                f"{f_nyq:.4g}/m at z={z:g} m: the mask erases nearly the "
                f"whole spectrum; reduce z or coarsen the grid"))
    if method == "fresnel":
        a = n * pixel_size / 2.0
        z_min = (math.pi * a ** 4 / (4.0 * wavelength)) ** (1.0 / 3.0)
        if z < z_min:
            out.append(PhysicsViolation(
                "fresnel-near-field", WARNING, where,
                f"z={z:g} m is under the Fresnel-approximation bound "
                f"(pi*a^4/(4*lambda))^(1/3)={z_min:.4g} m for half-aperture "
                f"a={a:g} m: parabolic wavefronts are inaccurate this "
                f"close; use rs"))


def validate_config(cfg) -> List[PhysicsViolation]:
    """All physics violations of a ``DONNConfig`` (empty list == valid).

    Pure function of the config value — no jax, no plan building — so it
    is equally callable from the linter's static evaluation of a config
    literal and from ``plan_from_config`` on the real object.
    """
    out: List[PhysicsViolation] = []
    if cfg.n < 2:
        out.append(PhysicsViolation(
            "geometry", ERROR, "system",
            f"system size n must be >= 2, got {cfg.n}"))
    if not cfg.pixel_size > 0.0:
        out.append(PhysicsViolation(
            "geometry", ERROR, "system",
            f"pixel_size must be > 0, got {cfg.pixel_size!r}"))
    if not cfg.wavelength > 0.0:
        out.append(PhysicsViolation(
            "geometry", ERROR, "system",
            f"wavelength must be > 0, got {cfg.wavelength!r}"))
    if out:
        return out  # derived criteria are meaningless on broken geometry

    specs = cfg.resolved_layers()
    gaps = cfg.gap_distances()
    for i, s in enumerate(specs):
        where = f"layer {i}"
        if s.size < 2 or not s.pixel_size > 0.0:
            out.append(PhysicsViolation(
                "geometry", ERROR, where,
                f"plane geometry must be positive, got size={s.size}, "
                f"pixel_size={s.pixel_size!r}"))
            return out
        _check_hop(out, s.size, s.pixel_size, s.distance, cfg.wavelength,
                   s.approximation, cfg.band_limit, cfg.pad, where)
        if s.codesign != "none":
            levels = s.device_levels
            if (levels is None or levels < MIN_DEVICE_LEVELS
                    or levels > MAX_DEVICE_LEVELS):
                out.append(PhysicsViolation(
                    "device-levels", ERROR, where,
                    f"codesign={s.codesign!r} needs "
                    f"{MIN_DEVICE_LEVELS} <= device_levels <= "
                    f"{MAX_DEVICE_LEVELS} (to_slm uint16 export domain), "
                    f"got {levels!r}"))
    # final free-space hop runs on the last layer's grid, then stitches
    # onto the detector grid
    last = specs[-1]
    _check_hop(out, last.size, last.pixel_size, gaps[-1], cfg.wavelength,
               last.approximation, cfg.band_limit, cfg.pad, "detector hop")

    # stitch compatibility along the plane chain: layer i -> layer i+1,
    # then last layer -> detector grid (the source plane IS layer 0's
    # grid, so the input embed never stitches)
    chain = [(f"layer {i}", s.size, s.pixel_size)
             for i, s in enumerate(specs)]
    chain.append(("detector", cfg.n, float(cfg.pixel_size)))
    for (name_a, _, dx_a), (name_b, _, dx_b) in zip(chain, chain[1:]):
        ratio = dx_b / dx_a
        if ratio > MAX_STITCH_PITCH_RATIO:
            out.append(PhysicsViolation(
                "stitch-undersample", ERROR, f"{name_a} -> {name_b}",
                f"resampling onto a {ratio:.3g}x coarser grid "
                f"({dx_a:g} m -> {dx_b:g} m) aliases the field (bilinear "
                f"stitches carry no anti-alias filter); keep the pitch "
                f"ratio <= {MAX_STITCH_PITCH_RATIO:g}"))
    return out


def check_config(cfg, stacklevel: int = 2) -> None:
    """Raise on hard violations, ``warnings.warn`` the soft ones.

    The build-time entry point: ``plan_from_config`` and ``dsl.from_spec``
    route every spec through here (once per plan-cache miss).
    """
    violations = validate_config(cfg)
    errors = [v for v in violations if v.severity == ERROR]
    for v in violations:
        if v.severity == WARNING:
            warnings.warn(str(v), PhysicsWarning, stacklevel=stacklevel)
    if errors:
        raise PhysicsValidationError(errors)
