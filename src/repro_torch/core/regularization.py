"""Physics-aware complex-valued regularization (paper §3.2), PyTorch side.

The port of ``repro.core.regularization``.  The detected intensity of a
DONN scales as gamma^(2 * depth), and its absolute scale acts as the
inverse softmax temperature of the MSE(softmax(I)) loss: too large
saturates the softmax and starves the gradients.  ``calibrate_gamma``
picks the gamma that brings the mean detector intensity to a target;
``recalibrated`` rebuilds a model with it.
"""
from __future__ import annotations

import dataclasses

import torch


def apply_gamma(u: torch.Tensor, gamma: float) -> torch.Tensor:
    """Scale field amplitude by gamma (phase untouched)."""
    return u * gamma


def energy(u: torch.Tensor) -> torch.Tensor:
    return torch.sum(u.real ** 2 + u.imag ** 2, dim=(-2, -1))


@torch.no_grad()
def calibrate_gamma(model, params, x, target_logit: float = 2.0) -> float:
    """Gamma that brings the mean per-class detector intensity of ``x`` to
    ``target_logit``: gamma = gamma0 (target / measured)^(1 / (2 depth))."""
    logits = model.apply(params, torch.as_tensor(x).to(model.device))
    m = float(torch.mean(logits))
    g0 = getattr(model, "gamma", 1.0)
    return float(g0 * (target_logit / max(m, 1e-30))
                 ** (1.0 / (2.0 * model.cfg.depth)))


def recalibrated(model_cls, cfg, params, x, laser=None, device=None):
    """Rebuild a model with calibrated gamma: (new model, gamma), both on
    ``device`` (the card by default)."""
    g = calibrate_gamma(model_cls(cfg, laser, device=device), params, x)
    return model_cls(dataclasses.replace(cfg, gamma=g), laser,
                     device=device), g
