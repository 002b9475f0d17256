"""Hardware-software codesign (LightRidge §3.3).

The port of ``repro.core.codesign``: device response curves, QAT rounding
with the straight-through estimator, the Gumbel-Softmax relaxation (soft
or straight-through hard, with or without noise), post-training
quantization and the fabrication exports (``to_slm``, ``to_3d_render``).
``.detach()`` is the reference's ``jax.lax.stop_gradient``: the rounded
correction carries no gradient, so d phi_eff / d phi is 1 (``torch.round``
alone has a zero gradient).

**The rng contract.**  Where the reference takes a JAX key, the port takes
an explicit ``torch.Generator`` on the field's device, and every Gumbel
draw goes through one function, ``gumbel_noise``, called once per layer
with the (n, n, levels) shape of one phase plane: a layer's draw is shared
by its channels (a (C, n, n) phase stack broadcasts it), as the
reference's one key per layer is.  A forward draws in global layer order
0..L-1 on both engines (all of a stack's layers before the first hop on
the scan engine, each layer before its hop on the eager one: the same
sequence), ``emulate_batch`` candidate by candidate, each over the padded
depth, and training step by step, so chunked and per-step training
consume one generator identically.  torch's Philox and JAX's threefry
differ, so no draw matches the reference's bit for bit: the parity tests
replace ``gumbel_noise`` with the reference's own draws, in call order.

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


def slm(levels: int = 256, response_gamma: float = 1.0,
        name: str = "slm-lc2012") -> DeviceSpec:
    """High-precision spatial light modulator preset (visible-range SLM)."""
    return DeviceSpec(levels=levels, response_gamma=response_gamma, name=name)


def printed_mask(levels: int = 4, response_gamma: float = 1.0,
                 name: str = "printed-mask") -> DeviceSpec:
    """Low-precision 3D-printed THz mask preset (few thickness levels)."""
    return DeviceSpec(levels=levels, response_gamma=response_gamma, name=name)


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


def gumbel_noise(generator: torch.Generator, shape, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with u uniform on
    [tiny, 1) from ``generator`` (the reference's ``jax.random.gumbel``
    formula).  Every noise draw of the port goes through here, once per
    layer; the parity tests replace it to inject the reference's draws."""
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def _check_rng(rng) -> None:
    if rng is not None and not isinstance(rng, torch.Generator):
        raise TypeError(
            f"rng must be a torch.Generator on the field's device, got "
            f"{type(rng).__name__}"
        )


def quantize_gumbel(
    phi: torch.Tensor,
    dev: DeviceSpec,
    rng: Optional[torch.Generator] = None,
    tau: float = 1.0,
    hard: bool = False,
) -> torch.Tensor:
    """Gumbel-Softmax differentiable discrete phase ([25, 36, 31]).

    Scores are negative squared circular distances to each device level;
    the softmax over levels gives the soft assignment (``hard`` takes the
    argmax level as the forward value with the soft assignment's
    gradient).  ``rng`` (a ``torch.Generator`` on phi's device) adds
    Gumbel noise to the scores: one (n, n, levels) draw, shared by any
    leading (channel) axes of phi.  rng=None gives the deterministic
    relaxation used at eval.
    """
    _check_rng(rng)
    levels = _levels(dev, phi)
    phi_w = wrap_phase(phi, dev.phase_range)
    d = phi_w[..., None] - levels
    # circular distance on the phase torus
    d = torch.minimum(torch.abs(d), dev.phase_range - torch.abs(d))
    logits = -(d * d) / (0.1 * dev.phase_range / dev.levels + 1e-12)
    if rng is not None:
        logits = logits + gumbel_noise(rng, logits.shape[-3:], logits.dtype,
                                       logits.device)
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


def to_slm(phi: torch.Tensor, dev: DeviceSpec) -> np.ndarray:
    """Export phase map as device level indices (uint8/uint16 image)."""
    idx, _ = weight_fab(phi, dev)
    arr = idx.detach().cpu().numpy()
    return arr.astype(np.uint8 if dev.levels <= 256 else np.uint16)


def to_3d_render(phi: torch.Tensor, wavelength: float,
                 delta_n: float = 0.52) -> np.ndarray:
    """Phase -> printed-mask thickness map t = phi * lambda / (2 pi dn) [m].

    delta_n: refractive-index contrast of the UV-curable resin (THz systems,
    paper §2.2 / Lin et al. [34]).
    """
    phi_w = wrap_phase(phi.detach()).cpu().numpy()
    return (phi_w * wavelength / (TWO_PI * delta_n)).astype(np.float32)


def deployed_phase(phi: torch.Tensor, dev: Optional[DeviceSpec],
                   mode: str) -> torch.Tensor:
    """Deploy-time (rng-free) device response: the phase the hardware holds."""
    return apply_codesign(phi, dev, mode, rng=None)


def apply_codesign(
    phi: torch.Tensor,
    dev: Optional[DeviceSpec],
    mode: str,
    rng: Optional[torch.Generator] = None,
    tau: float = 1.0,
) -> torch.Tensor:
    """Dispatch used by the hardware-aware diffractive layer.

    mode: "none" | "qat" | "gumbel" | "gumbel_hard" | "ptq"; ``rng``, a
    ``torch.Generator``, is drawn from only by the Gumbel modes.
    """
    _check_rng(rng)
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
