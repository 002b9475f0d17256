"""Hardware-software codesign (LightRidge §3.3).

The port of ``repro.core.codesign``: device response curves, QAT rounding
with the straight-through estimator, the deterministic (rng-free) Gumbel
relaxation (soft or straight-through hard) and post-training
quantization.  ``.detach()`` is the reference's ``jax.lax.stop_gradient``:
the rounded correction carries no gradient, so d phi_eff / d phi is 1
(``torch.round`` alone has a zero gradient).  Gumbel noise (``rng``)
comes with the DSE/codesign slice.

``wrap_phase`` is ``torch.remainder`` — a floored modulo with the sign of
the divisor, like ``jnp.mod``; ``torch.fmod`` truncates and would keep
negative phases negative.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """A phase-modulation device (SLM pixel array or printed mask).

    ``levels`` discrete states span ``phase_range``; ``response_gamma`` models
    a nonlinear voltage->phase response curve phi(v) = range * (v/(L-1))^g —
    g=1 is ideal, measured SLMs deviate (paper §2.2).
    """

    levels: int = 256
    phase_range: float = TWO_PI
    response_gamma: float = 1.0
    name: str = "slm-lc2012"

    def level_phases(self) -> np.ndarray:
        # L states tile [0, phase_range) with spacing range/L (the top state
        # wraps to 0 on the phase torus), matching the QAT rounding grid.
        v = np.arange(self.levels) / self.levels
        return (self.phase_range * v**self.response_gamma).astype(np.float32)


def device_for_layer(codesign: str, levels: int,
                     response_gamma: float = 1.0) -> Optional[DeviceSpec]:
    """The DeviceSpec one layer's codesign knobs describe, or None."""
    if codesign == "none":
        return None
    return DeviceSpec(levels=int(levels), response_gamma=float(response_gamma))


def _levels(dev: DeviceSpec, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(dev.level_phases()).to(like.device)


def wrap_phase(phi: torch.Tensor, phase_range: float = TWO_PI) -> torch.Tensor:
    return torch.remainder(phi, phase_range)


def quantize_qat(phi: torch.Tensor, dev: DeviceSpec) -> torch.Tensor:
    """Straight-through-estimator quantization-aware phase (QAT [28]).

    ``phi_w + (q - phi_w).detach()`` is the reference's spelling: the two
    sums round as its forward does, and the gradient is that of ``phi_w``.
    """
    phi_w = wrap_phase(phi, dev.phase_range)
    if dev.response_gamma == 1.0:
        step = dev.phase_range / dev.levels
        q = torch.remainder(torch.round(phi_w / step), dev.levels) * step
    else:
        levels = _levels(dev, phi_w)
        idx = torch.argmin(torch.abs(phi_w[..., None] - levels), dim=-1)
        q = levels[idx]
    return phi_w + (q - phi_w).detach()


def quantize_gumbel(
    phi: torch.Tensor,
    dev: DeviceSpec,
    rng=None,
    tau: float = 1.0,
    hard: bool = False,
) -> torch.Tensor:
    """Gumbel-Softmax discrete phase ([25, 36, 31]), rng-free relaxation.

    Scores are negative squared circular distances to each device level; the
    softmax over levels gives the soft assignment (``hard`` takes the argmax
    level as the forward value with the soft assignment's gradient).  Noise
    (``rng``) comes with the DSE/codesign slice.
    """
    if rng is not None:
        raise NotImplementedError(
            "rng-driven Gumbel codesign comes with the DSE/codesign slice; "
            "the port resolves the deterministic relaxation (rng=None)"
        )
    levels = _levels(dev, phi)
    phi_w = wrap_phase(phi, dev.phase_range)
    d = phi_w[..., None] - levels
    # circular distance on the phase torus
    d = torch.minimum(torch.abs(d), dev.phase_range - torch.abs(d))
    logits = -(d * d) / (0.1 * dev.phase_range / dev.levels + 1e-12)
    soft = torch.softmax(logits / tau, dim=-1)
    phi_soft = torch.sum(soft * levels, dim=-1)
    if hard:
        phi_hard = levels[torch.argmax(logits, dim=-1)]
        phi_soft = phi_soft + (phi_hard - phi_soft).detach()
    return phi_soft


def weight_fab(phi: torch.Tensor, dev: DeviceSpec) -> tuple:
    """Post-training quantization to fabrication levels (lr.layers.weight_fab).

    Returns (level_indices int32, achieved_phase float32).
    """
    levels = _levels(dev, phi)
    phi_w = wrap_phase(phi, dev.phase_range)
    d = phi_w[..., None] - levels
    d = torch.minimum(torch.abs(d), dev.phase_range - torch.abs(d))
    idx = torch.argmin(d, dim=-1)
    return idx.to(torch.int32), levels[idx]


def deployed_phase(phi: torch.Tensor, dev: Optional[DeviceSpec],
                   mode: str) -> torch.Tensor:
    """Deploy-time (rng-free) device response: the phase the hardware holds."""
    return apply_codesign(phi, dev, mode, rng=None)


def apply_codesign(
    phi: torch.Tensor,
    dev: Optional[DeviceSpec],
    mode: str,
    rng=None,
    tau: float = 1.0,
) -> torch.Tensor:
    """Dispatch used by the hardware-aware diffractive layer.

    mode: "none" | "qat" | "gumbel" | "gumbel_hard" | "ptq".
    """
    if dev is None or mode == "none":
        return phi
    if mode == "qat":
        return quantize_qat(phi, dev)
    if mode == "gumbel":
        return quantize_gumbel(phi, dev, rng, tau=tau, hard=False)
    if mode == "gumbel_hard":
        return quantize_gumbel(phi, dev, rng, tau=tau, hard=True)
    if mode == "ptq":
        return weight_fab(phi, dev)[1]
    raise ValueError(f"unknown codesign mode {mode!r}")
