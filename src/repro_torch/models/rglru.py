"""RG-LRU recurrent block (recurrentgemma-9b / Griffin).

Port of ``repro.models.rglru``.  Recurrent block: two input branches —
(linear -> causal conv -> RG-LRU) and (linear -> GeLU) — multiplied,
then projected out.  The RG-LRU recurrence:

    r_t = sigmoid(blockdiag(W_a) x_t + b_a)          (recurrence gate)
    i_t = sigmoid(blockdiag(W_x) x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(-Lambda) * r_t)          (a = sigmoid(Lambda))
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Gates use block-diagonal weights with n_heads blocks (Griffin's design).
The scan runs the reference's chunks step by step in torch ops (padded
with a = 1, which keeps h); under autograd each chunk is recomputed in
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of its chunk body), as ``ssm._selective_scan`` does.

On an LM mesh (``repro_torch.runtime.sharding.context()``) the ``lru``
channels (``mlp``) and the gate heads (``heads``) are split over
``model``, a rank's heads being exactly its channels' blocks; the block
enters with the whole sequence and leaves through the row-parallel
``w_out``.  Where ``n_heads`` does not divide the model degree
(``MeshContext.whole``; so wherever ``lru_width``, a multiple of it, does
not) every ``model`` rank runs the whole block on the gathered weights and
states, its output whole, and keeps its channels of the new states where
``lru_width`` divides (whole states where it does not).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import LMConfig
from repro_torch.models.layers import _gelu
from repro_torch.models.ssm import _causal_conv
from repro_torch.nn import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_gather_dim

RG_C = 8.0


def rglru_spec(cfg: LMConfig):
    d, lru, h = cfg.d_model, cfg.lru_width, cfg.n_heads
    bs = lru // h  # gate block size
    f32 = torch.float32
    return {
        "w_in": ParamSpec((d, lru), f32, ("embed", "mlp")),
        "w_gate_branch": ParamSpec((d, lru), f32, ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.d_conv, lru), f32, (None, "mlp"),
                            init="normal", scale=0.5),
        "conv_b": ParamSpec((lru,), f32, ("mlp",), init="zeros"),
        "w_a": ParamSpec((h, bs, bs), f32, ("heads", None, None)),
        "b_a": ParamSpec((lru,), f32, ("mlp",), init="zeros"),
        "w_x": ParamSpec((h, bs, bs), f32, ("heads", None, None)),
        "b_x": ParamSpec((lru,), f32, ("mlp",), init="zeros"),
        "lam": ParamSpec((lru,), f32, ("mlp",), init="rglru_lambda"),
        "w_out": ParamSpec((lru, d), f32, ("mlp", "embed")),
    }


def _blockdiag(x, w, b, n_heads: int):
    """x: (B, S, lru) -> block-diagonal linear per head + bias."""
    B, S, lru = x.shape
    bs = lru // n_heads
    xh = x.reshape(B, S, n_heads, bs)
    y = torch.einsum("bshi,hij->bshj", xh, w.to(x.dtype))
    return y.reshape(B, S, lru) + b.to(x.dtype)


def _lru_chunk(h, a_c, g_c):
    """The steps of one chunk: (h after them, every step's h)."""
    ys = []
    # unbind: one backward op a chunk stacks the steps' grads
    for a1, g1 in zip(a_c.unbind(1), g_c.unbind(1)):
        h = a1 * h + g1
        ys.append(h)
    return h, torch.stack(ys, dim=1)


def _lru_scan(a_t, gx, h0, chunk: int):
    """h_t = a_t h_{t-1} + gx_t; a_t, gx: (B, S, lru) f32; h0: (B, lru).

    Returns (y (B, S, lru), h_final)."""
    B, S, lru = gx.shape
    chunk = max(1, min(chunk, S))
    pad = (-S) % chunk
    if pad:  # padded steps have a = 1, gx = 0: h unchanged
        a_t = F.pad(a_t, (0, 0, 0, pad), value=1.0)
        gx = F.pad(gx, (0, 0, 0, pad))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (a_t, gx, h0))
    h = h0
    ys = []
    for c in range(0, S + pad, chunk):
        args = (h, a_t[:, c:c + chunk], gx[:, c:c + chunk])
        if remat:
            h, y = checkpoint(_lru_chunk, *args, use_reentrant=False)
        else:
            h, y = _lru_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def apply_rglru_block(
    p,
    x,
    cfg: LMConfig,
    conv_state: Optional[torch.Tensor] = None,
    lru_state: Optional[torch.Tensor] = None,
):
    """Full Griffin recurrent block. x: (B, S, d).

    Returns (out, (new_conv_state, new_lru_state)).  On a mesh ``x`` and
    ``out`` are the residual stream's layout and the states this rank's
    channels.
    """
    ctx = shd.context()
    # lru_width = n_heads * block: whole heads cover a whole lru_width too
    whole = ctx.whole(cfg.n_heads)
    h_lo, h_hi = ctx.part(cfg.n_heads)
    spec = rglru_spec(cfg)
    # whole heads over a rank's channels of the states: they are gathered,
    # and the new states cut back to this rank's channels
    cut = whole and conv_state is not None and \
        conv_state.shape[-1] != cfg.lru_width
    if cut:
        g = ctx.group("model")
        conv_state = all_gather_dim(conv_state.contiguous(), g, -1)
        lru_state = all_gather_dim(lru_state.contiguous(), g, -1)

    def w(name, dim):
        return ctx.model_part(p[name], spec[name], None if whole else dim)

    x = ctx.enter(x)
    B = x.shape[0]
    dt = cfg.dtype
    x1 = x @ w("w_in", 1).to(dt)
    x2 = _gelu(x @ w("w_gate_branch", 1).to(dt))
    x1, new_conv = _causal_conv(x1, w("conv_w", 1), w("conv_b", 0),
                                state=conv_state)
    # --- RG-LRU ---
    xf = x1.float()
    r = torch.sigmoid(_blockdiag(xf, w("w_a", 0), w("b_a", 0), h_hi - h_lo))
    i = torch.sigmoid(_blockdiag(xf, w("w_x", 0), w("b_x", 0), h_hi - h_lo))
    log_a = -RG_C * r * F.softplus(-w("lam", 0))  # (B, S, lru)
    a_t = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=1e-12)) * (i * xf)
    h0 = (lru_state if lru_state is not None
          else torch.zeros((B, xf.shape[-1]), dtype=torch.float32,
                           device=x.device))
    y, h = _lru_scan(a_t, gated, h0, cfg.scan_chunk)
    out = (y.to(dt) * x2) @ w("w_out", 0).to(dt)
    if cut:
        lo, hi = ctx.part(cfg.lru_width)
        new_conv, h = new_conv[..., lo:hi], h[..., lo:hi]
    return ctx.exit(out, whole), (new_conv, h)
