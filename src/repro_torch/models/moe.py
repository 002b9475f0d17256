"""Mixture-of-Experts blocks (mixtral-8x7b, arctic-480b).

Port of ``repro.models.moe``: capacity-based GShard-style einsum
dispatch, as the reference computes it.  Tokens are grouped (per
sequence by default, ``moe_group`` or ``min(S, 4096)``, all ``B * S``
tokens when the group does not divide them), each token picks its
``top_k`` experts by router probability, and each (token, slot) pair
takes the next free position of its expert's ``C = expert_capacity``
slots; pairs past ``C`` are dropped.  Dispatch and combine are one-hot
einsums over (group, token, expert, slot).  The reference's sharding
hints (``constrain``) have no counterpart on one card and are dropped.

Returns a Switch-style load-balancing auxiliary loss beside the outputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import LMConfig
from repro_torch.models.layers import apply_mlp, mlp_spec
from repro_torch.nn import ParamSpec


def moe_spec(cfg: LMConfig):
    d, E = cfg.d_model, cfg.n_experts
    f = cfg.expert_d_ff or cfg.d_ff
    f32 = torch.float32
    spec = {
        "router": ParamSpec((d, E), f32, ("embed", None)),
        "w_gate": ParamSpec((E, d, f), f32, ("expert", "embed", "mlp")),
        "w_up": ParamSpec((E, d, f), f32, ("expert", "embed", "mlp")),
        "w_down": ParamSpec((E, f, d), f32, ("expert", "mlp", "embed")),
    }
    if cfg.dense_residual_ff:
        spec["dense"] = mlp_spec(cfg, cfg.dense_residual_ff)
    return spec


def expert_capacity(cfg: LMConfig, group: int) -> int:
    c = int(math.ceil(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(4, -(-c // 4) * 4)  # multiple of 4, >= 4


def _one_hot(x, n: int):
    """``jax.nn.one_hot(x, n)`` in float32: a row of zeros where ``x`` is
    outside ``[0, n)`` (``F.one_hot`` raises there)."""
    return (x[..., None] == torch.arange(n, device=x.device)).float()


def route(p, xg, cfg: LMConfig):
    """Router probabilities (G, g, E) and the top-k (weights, experts) of
    each token, ``jax.lax.top_k``'s order: descending, the lower expert
    first on a tie; the weights renormalised to sum to one."""
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return probs, weights, idx


def apply_moe(p, x, cfg: LMConfig, group_size: int = 0):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = cfg.dtype
    g = group_size or cfg.moe_group or min(S, 4096)
    T = B * S
    if T % g:
        g = T  # degenerate fallback (smoke shapes)
    xg = x.reshape(T // g, g, d)  # (G, g, d)
    probs, weights, idx = route(p, xg, cfg)

    C = expert_capacity(cfg, g)
    eh = _one_hot(idx, E)  # (G, g, k, E)
    # each (token, slot) pair's position within its expert: a cumsum over
    # the pairs flattened token-major, slot inner (the reference's order,
    # which decides the dropped pairs)
    ehf = eh.reshape(-1, g * k, E)
    pos = (torch.cumsum(ehf, dim=1) - ehf).reshape(-1, g, k, E)
    pos_slot = torch.sum(pos * eh, dim=-1)  # (G, g, k)
    keep = (pos_slot < C).float()
    poh = _one_hot(pos_slot, C)  # (G, g, k, C); dropped pairs all zero
    combine = torch.einsum("gtke,gtkc->gtec",
                           eh * (weights * keep)[..., None], poh).to(dt)
    dispatch = (combine > 0).to(dt)

    xd = torch.einsum("gtec,gtd->gecd", dispatch, xg.to(dt))
    h = torch.einsum("gecd,edf->gecf", xd, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", xd, p["w_up"].to(dt))
    eo = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["w_down"].to(dt))
    out = torch.einsum("gtec,gecd->gtd", combine, eo).reshape(B, S, d)

    # Switch-style load-balancing auxiliary loss
    me = torch.mean(probs, dim=1)  # (G, E) mean router prob
    ce = torch.mean(eh[:, :, 0, :], dim=1)  # (G, E) top-1 assignment share
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))

    if cfg.dense_residual_ff:
        out = out + apply_mlp(p["dense"], x, cfg)
    return out, aux
