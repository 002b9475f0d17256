"""Shared LM building blocks: norms, MLPs, embeddings, RoPE.

Port of ``repro.models.layers``.  Parameters stay float32 and each is cast
to ``cfg.dtype`` at its matmul, as in the reference (``apply_mlp``,
``unembed``), so the port rounds where the reference rounds.

On an LM mesh (``repro_torch.runtime.sharding.context()``) each rank holds
its blocks of the parameters: norms run on the rank's tokens of the
residual stream; the MLP enters with the whole sequence, runs column- then
row-parallel over ``model`` and leaves through ``MeshContext.exit``; the
embedding looks up every ``data`` rank's tokens in the rank's columns of
the table and gathers the rows' columns; ``unembed`` gives this rank's
``vocab`` part of the logits.  A ``d_ff`` or a vocabulary that does not
divide over ``model`` (``MeshContext.whole``) runs whole on every ``model``
rank, as the reference replicates it: the whole MLP, its output whole; the
whole logits.  Off a mesh the same code runs on the one-device context,
whose parts are whole and collectives identities.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_gather_dim, gather_dim


# ------------------------------------------------------------------- norms
def norm_spec(cfg: LMConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    return {"scale": ParamSpec((d,), torch.float32, ("embed",), init="ones")}


def apply_norm(p, x, cfg: LMConfig):
    xf = x.float()
    if cfg.norm == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
    scale = shd.context().model_part(  # gathered over data on a mesh
        p["scale"], norm_spec(cfg, x.shape[-1])["scale"])
    return (y * scale.float()).to(x.dtype)


# -------------------------------------------------------------------- mlps
def mlp_spec(cfg: LMConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), torch.float32, ("embed", "mlp")),
            "w_up": ParamSpec((d, f), torch.float32, ("embed", "mlp")),
            "w_down": ParamSpec((f, d), torch.float32, ("mlp", "embed")),
        }
    return {  # plain gelu MLP
        "w_up": ParamSpec((d, f), torch.float32, ("embed", "mlp")),
        "b_up": ParamSpec((f,), torch.float32, ("mlp",), init="zeros"),
        "w_down": ParamSpec((f, d), torch.float32, ("mlp", "embed")),
        "b_down": ParamSpec((d,), torch.float32, ("embed",), init="zeros"),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_partial(p, x, cfg: LMConfig, d_ff: Optional[int] = None):
    """The MLP of the whole-sequence ``x`` without ``b_down``; on a mesh
    this rank's partial sums over ``model`` (columns of ``w_gate``/
    ``w_up``, rows of ``w_down``), which the caller sums (``exit``), or
    the whole MLP where ``d_ff`` does not divide (``MeshContext.whole``)."""
    ctx = shd.context()
    dt = cfg.dtype
    spec = mlp_spec(cfg, d_ff)

    def w(name, dim):
        return ctx.model_part(p[name], spec[name], dim).to(dt)

    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ w("w_gate", 1)
        u = x @ w("w_up", 1)
        act = F.silu(g) if cfg.mlp == "swiglu" else _gelu(g)
        return (act * u) @ w("w_down", 0)
    h = x @ w("w_up", 1) + w("b_up", 0)
    h = _gelu(h)
    return h @ w("w_down", 0)


def mlp_bias(p, y, cfg: LMConfig, d_ff: Optional[int] = None):
    """``y`` (summed ``mlp_partial``s) plus ``b_down`` where the MLP has
    one."""
    if cfg.mlp in ("swiglu", "geglu"):
        return y
    b = shd.context().model_part(p["b_down"], mlp_spec(cfg, d_ff)["b_down"])
    return y + b.to(cfg.dtype)


def apply_mlp(p, x, cfg: LMConfig, d_ff: Optional[int] = None):
    """The MLP of ``x``; on a mesh ``x`` and the output are the residual
    stream's layout (``d_ff``: the width, ``cfg.d_ff`` unless given)."""
    ctx = shd.context()
    y = ctx.exit(mlp_partial(p, ctx.enter(x), cfg, d_ff),
                 ctx.whole(d_ff or cfg.d_ff))
    return mlp_bias(p, y, cfg, d_ff)


# -------------------------------------------------------------- embeddings
def embed_spec(cfg: LMConfig):
    spec = {
        "table": ParamSpec(
            (cfg.vocab, cfg.d_model), torch.float32, (None, "embed"),
            init="embed", scale=0.02,
        )
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec(
            (cfg.d_model, cfg.vocab), torch.float32, (None, "vocab"),
            init="fan_in",
        )
    return spec


def embed_tokens(p, tokens, cfg: LMConfig):
    """The embedding rows of ``tokens``; on a mesh the rank looks up every
    ``data`` rank's tokens in its block of the table's columns and the
    columns are gathered over ``data`` (a few MB of activations, not the
    whole table), then it keeps its own rows."""
    ctx = shd.context()
    axes = ctx.spec(embed_spec(cfg)["table"])[1]
    if axes is None:
        return p["table"][tokens].to(cfg.dtype)
    group = shd.axes_group(ctx.mesh, axes)
    rows = tokens.shape[0]
    if ctx.batch_sharded:  # the other data ranks' tokens
        tokens = all_gather_dim(tokens.contiguous(), group, 0)
    x = gather_dim(p["table"][tokens], group, -1)
    if ctx.batch_sharded:
        i = shd.axes_index(ctx.mesh, axes)[0]
        x = x[i * rows:(i + 1) * rows]
    return x.to(cfg.dtype)


def vocab_part(cfg: LMConfig) -> tuple:
    """(lo, hi) of the vocabulary this rank's logits cover (all of it off
    a mesh, or where it does not divide over ``model``)."""
    return shd.context().part(cfg.vocab)


def unembed(p, x, cfg: LMConfig):
    """Logits of ``x``; on a mesh this rank's ``vocab_part`` of them."""
    ctx = shd.context()
    spec = embed_spec(cfg)
    if cfg.tie_embeddings:
        w = ctx.model_part(p["table"], spec["table"], 0).to(cfg.dtype).T
    else:
        w = ctx.model_part(p["unembed"], spec["unembed"], 1).to(cfg.dtype)
    logits = x @ w
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c)
    return logits


# -------------------------------------------------------------------- rope
def rope_angles(cfg: LMConfig, positions: torch.Tensor):
    """cos/sin tables for positions (...,) -> (..., rot_dim//2), float32."""
    rot = int(cfg.head_dim * cfg.partial_rotary)
    rot -= rot % 2
    expo = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv_freq = 1.0 / (cfg.rope_theta ** expo)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin, cfg: LMConfig, use_pallas: bool = False):
    """x: (B, S, H, Dh); cos/sin: (B?, S, rot//2). Rotate-half convention.

    Partial rotary (glm4): only the first ``rot`` features rotate.  With
    ``use_pallas`` the rotation runs through K6 (``kernels.ops.apply_rope``)
    on the (B*H, S, rot) layout the kernel takes, with cos/sin cast to
    ``x.dtype`` first, as the reference does; the served model keeps the
    flag off, as the reference's callers do.
    """
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    if use_pallas:
        from repro_torch.kernels import ops as kops

        b, s, h, d = xr.shape
        # the kernel takes (..., S, D): fold heads into batch
        xk = xr.transpose(1, 2).reshape(b * h, s, d)
        ck = cos if cos.dim() == 2 else cos[0]
        sk = sin if sin.dim() == 2 else sin[0]
        out = kops.apply_rope(xk, ck.to(x.dtype), sk.to(x.dtype))
        xr = out.reshape(b, h, s, d).transpose(1, 2)
    else:
        half = rot // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        c = cos[..., None, :].to(x.dtype)  # (B?, S, 1, half)
        s = sin[..., None, :].to(x.dtype)
        if c.dim() == 3:  # (S, 1, half) -> broadcast over batch
            c, s = c[None], s[None]
        xr = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    if xp.shape[-1] == 0:
        return xr
    return torch.cat([xr, xp], dim=-1)
