"""Shared LM building blocks: norms, MLPs, embeddings, RoPE.

Port of ``repro.models.layers``.  Parameters stay float32 and each is cast
to ``cfg.dtype`` at its matmul, as in the reference (``apply_mlp``,
``unembed``), so the port rounds where the reference rounds.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec


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
    return (y * p["scale"].float()).to(x.dtype)


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


def apply_mlp(p, x, cfg: LMConfig):
    dt = cfg.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.mlp == "swiglu" else _gelu(g)
        return (act * u) @ p["w_down"].to(dt)
    h = x @ p["w_up"].to(dt) + p["b_up"].to(dt)
    h = _gelu(h)
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


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
    return p["table"][tokens].to(cfg.dtype)


def unembed(p, x, cfg: LMConfig):
    if cfg.tie_embeddings:
        w = p["table"].to(cfg.dtype).T
    else:
        w = p["unembed"].to(cfg.dtype)
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
