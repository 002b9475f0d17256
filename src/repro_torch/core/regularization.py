"""Physics-aware complex-valued regularization (paper §3.2), PyTorch side.

``calibrate_gamma`` from ``repro.core.regularization``.  The detected
intensity of a DONN scales as gamma^(2 * depth), and its absolute scale
acts as the inverse softmax temperature of the MSE(softmax(I)) loss: too
large saturates the softmax and starves the gradients.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def calibrate_gamma(model, params, x, target_logit: float = 2.0) -> float:
    """Gamma that brings the mean per-class detector intensity of ``x`` to
    ``target_logit``: gamma = gamma0 (target / measured)^(1 / (2 depth))."""
    logits = model.apply(params, torch.as_tensor(x).to(model.device))
    m = float(torch.mean(logits))
    g0 = getattr(model, "gamma", 1.0)
    return float(g0 * (target_logit / max(m, 1e-30))
                 ** (1.0 / (2.0 * model.cfg.depth)))
