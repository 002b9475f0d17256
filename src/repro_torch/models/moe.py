"""Mixture-of-Experts blocks (mixtral-8x7b, arctic-480b).

Port of ``repro.models.moe``: capacity-based GShard-style einsum
dispatch, as the reference computes it.  Tokens are grouped (per
sequence by default, ``moe_group`` or ``min(S, 4096)``, all ``B * S``
tokens when the group does not divide them), each token picks its
``top_k`` experts by router probability, and each (token, slot) pair
takes the next free position of its expert's ``C = expert_capacity``
slots; pairs past ``C`` are dropped.  Dispatch and combine are one-hot
einsums over (group, token, expert, slot).

On an LM mesh (``repro_torch.runtime.sharding.context()``) the block
enters with the whole sequence and every ``model`` rank routes alike (the
router is replicated); with ``expert`` over ``model`` each rank
dispatches to, runs and combines only its own experts (the reference's
``constrain(..., require="expert")``), otherwise every rank runs every
expert on its ``mlp`` columns; the partial outputs leave through
``MeshContext.exit``.  Where neither ``n_experts`` nor ``expert_d_ff``
divides over ``model`` (``MeshContext.whole``) every rank runs every
expert whole and its output leaves whole, as the reference replicates
both dims.  The capacity groups are the unsharded run's: where one would
straddle two ``data`` ranks, the block runs on the whole batch gathered
over ``data`` (every ``data`` rank alike) and keeps its own rows, as the
reference's groups span the global batch.

Returns a Switch-style load-balancing auxiliary loss beside the outputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import LMConfig
from repro_torch.models.layers import mlp_bias, mlp_partial, mlp_spec
from repro_torch.nn import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import gather_dim


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
    # replicated on model, gathered over data on a mesh
    router = shd.context().model_part(p["router"], moe_spec(cfg)["router"])
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return probs, weights, idx


def _group_size(ctx, B: int, S: int, g: int) -> tuple:
    """(the unsharded run's group size, whether one of its groups
    straddles two ``data`` ranks' blocks of ``B`` rows): the size is all
    the global batch's tokens when ``g`` does not divide them (the smoke
    shapes' fallback)."""
    shards = ctx.size("data") if ctx.batch_sharded else 1
    T_all, T = B * shards * S, B * S
    if T_all % g:
        g = T_all  # the unsharded run's degenerate fallback
    return g, T % g != 0


def _expert_weights(ctx, p, cfg: LMConfig):
    """(w_gate, w_up, w_down) of this rank, in f32: its experts when
    ``expert`` maps to ``model``, else every expert's ``mlp`` columns.
    The caller casts each at its einsum, so one cast copy lives at a time
    (arctic's are 8.9 GB each in bf16)."""
    spec = moe_spec(cfg)
    ep = ctx.model_sharded(spec["w_gate"], 0)
    dims = {"w_gate": 0 if ep else 2, "w_up": 0 if ep else 2,
            "w_down": 0 if ep else 1}
    return tuple(ctx.model_part(p[n], spec[n], dims[n])
                 for n in ("w_gate", "w_up", "w_down"))


def apply_moe(p, x, cfg: LMConfig, group_size: int = 0):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    On a mesh ``x`` and ``out`` are the residual stream's layout and the
    aux loss is this rank's share."""
    ctx = shd.context()
    x = ctx.enter(x)
    rows, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = cfg.dtype
    g, straddles = _group_size(ctx, rows, S,
                               group_size or cfg.moe_group or min(S, 4096))
    if straddles:  # the global batch, every data rank alike
        x = gather_dim(x, ctx.group("data"), 0)
    B = x.shape[0]
    T = B * S
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

    # this rank's experts (or every expert's mlp columns)
    ax = (None, None, "expert", None)
    dispatch = shd.constrain(dispatch, ax, require="expert")
    combine = shd.constrain(combine, ax, require="expert")
    wg, wu, wd = _expert_weights(ctx, p, cfg)
    whole = ctx.whole(E) and ctx.whole(cfg.expert_d_ff or cfg.d_ff)
    xd = torch.einsum("gtec,gtd->gecd", dispatch, xg.to(dt))
    h = torch.einsum("gecd,edf->gecf", xd, wg.to(dt))
    u = torch.einsum("gecd,edf->gecf", xd, wu.to(dt))
    eo = torch.einsum("gecf,efd->gecd", F.silu(h) * u, wd.to(dt))
    out = torch.einsum("gtec,gecd->gtd", combine, eo).reshape(B, S, d)
    if cfg.dense_residual_ff:
        ff = cfg.dense_residual_ff
        dense = mlp_partial(p["dense"], x, cfg, ff)
        if ctx.whole(ff) == whole:  # one sum over model for both
            out = ctx.exit(out + dense, whole)
        else:
            out = ctx.exit(out, whole) + ctx.exit(dense, ctx.whole(ff))
        out = mlp_bias(p["dense"], out, cfg, ff)
    else:
        out = ctx.exit(out, whole)
    if straddles:  # this rank's rows
        i = ctx.index("data")
        out = out[i * rows:(i + 1) * rows]

    # Switch-style load-balancing auxiliary loss; on a mesh this rank's
    # share: its groups of the global batch, over every rank that routes
    # them alike
    me = torch.mean(probs, dim=1)  # (G, E) mean router prob
    ce = torch.mean(eh[:, :, 0, :], dim=1)  # (G, E) top-1 assignment share
    shards = ctx.size("data") if ctx.batch_sharded else 1
    share = 1.0 / (shards * ctx.copies())
    aux = E * torch.mean(torch.sum(me * ce, dim=-1)) * share
    return out, aux
