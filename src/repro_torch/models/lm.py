"""LM model assembly for the dense and ssm families (port of ``repro.models.lm``).

Parameters keep the reference's tree: per-layer blocks stacked on a
leading "layers" axis under ``params["blocks"]``.  Where the reference
runs ``lax.scan`` over that axis, the port runs a Python loop and indexes
each layer's slice (a view, no copy).  ``params["blocks"]`` may also be a
list of per-layer trees: the train step (``repro_torch.runtime.steps``)
passes views of the stacked leaves that it differentiates layer by layer,
so no layer's gradient is scattered into a stacked-size buffer.  With
``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(non-reentrant) whenever autograd records it, the reference's
``jax.checkpoint`` of the scan body; serving under ``no_grad`` is not
affected.

The loss is the reference's sequence-chunked softmax cross-entropy
(``chunked_xent``): logits are made one chunk at a time, upcast to f32,
and recomputed in backward.  The moe, vlm, audio and hybrid families come
with their slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import DENSE, MOE, PORTED_FAMILIES, LMConfig
from repro_torch.models.layers import (
    apply_mlp, apply_norm, embed_spec, embed_tokens, mlp_spec, norm_spec,
    unembed,
)
from repro_torch.nn import ParamSpec, init_params
from repro_torch.tree import tree_map


def _require_ported(cfg: LMConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) comes with its slice "
            "(ROADMAP queue 1 step 13); the port serves dense and ssm"
        )


# ------------------------------------------------------------------ helpers
def stack_specs(spec, n: int):
    """Add a leading stacked-layer axis to every ParamSpec in a tree."""
    return tree_map(
        lambda s: ParamSpec(
            (n,) + s.shape,
            s.dtype,
            ("layers",) + (s.logical_axes or (None,) * len(s.shape)),
            init=s.init,
            scale=s.scale,
        ),
        spec,
    )


def _layer(blocks, i: int):
    """Layer ``i``'s parameters: a view into each stacked leaf (or the
    ``i``-th tree of a per-layer list)."""
    if isinstance(blocks, list):
        return blocks[i]
    return tree_map(lambda a: a[i], blocks)


def _maybe_remat(fn, cfg: LMConfig):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` and
    autograd is recording: only the block's inputs are kept, its
    activations are recomputed in backward."""
    if not cfg.remat:
        return fn

    def run(*args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    return run


# ------------------------------------------------------------- block specs
def dense_block_spec(cfg: LMConfig):
    return {
        "ln1": norm_spec(cfg),
        "attn": attn.attention_spec(cfg),
        "ln2": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }


def ssm_block_spec(cfg: LMConfig):
    return {"ln1": norm_spec(cfg), "mamba": ssm_mod.mamba_spec(cfg)}


def param_specs(cfg: LMConfig):
    _require_ported(cfg)
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg),
        "final_norm": norm_spec(cfg),
    }
    block = dense_block_spec if cfg.family == DENSE else ssm_block_spec
    spec["blocks"] = stack_specs(block(cfg), cfg.n_layers)
    return spec


def init(cfg: LMConfig, gen: torch.Generator):
    """Random parameters on ``gen``'s device (float32, as the reference)."""
    return init_params(param_specs(cfg), gen)


# ---------------------------------------------------------- block applies
def _dense_block(p, x, cfg: LMConfig, window=None):
    x = x + attn.self_attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                                window=window)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _ssm_block(p, x, cfg: LMConfig):
    y, _ = ssm_mod.apply_mamba(p["mamba"], apply_norm(p["ln1"], x, cfg), cfg)
    return x + y


# ------------------------------------------------------------ full forward
def forward(params, tokens, cfg: LMConfig,
            vision: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (final hidden states (B, S, d) [pre-unembed], aux)."""
    _require_ported(cfg)
    x = embed_tokens(params["embed"], tokens, cfg)
    body = _maybe_remat(_dense_block if cfg.family == DENSE else _ssm_block,
                        cfg)
    for i in range(cfg.n_layers):
        x = body(_layer(params["blocks"], i), x, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, tokens, cfg: LMConfig, vision=None):
    x, _ = forward(params, tokens, cfg, vision)
    return unembed(params["embed"], x, cfg)


# ------------------------------------------------------------------ cache
def cache_specs(cfg: LMConfig, batch: int, cache_len: int):
    """ParamSpec tree (zeros) of the decode cache."""
    _require_ported(cfg)
    dt = cfg.dtype
    if cfg.family == DENSE:
        KV, Dh = cfg.n_kv_heads, cfg.head_dim
        L = min(cache_len, cfg.window) if cfg.window else cache_len
        ax = ("layers", "batch", None, "kv_heads", "head")
        shape = (cfg.n_layers, batch, L, KV, Dh)
        return {"k": ParamSpec(shape, dt, ax, init="zeros"),
                "v": ParamSpec(shape, dt, ax, init="zeros")}
    return {
        "conv": ParamSpec(
            (cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
            dt, ("layers", "batch", None, "mlp"), init="zeros",
        ),
        "h": ParamSpec(
            (cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
            torch.float32, ("layers", "batch", "mlp", None), init="zeros",
        ),
    }


def init_cache(cfg: LMConfig, batch: int, cache_len: int, device=None):
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_specs(cfg, batch, cache_len),
    )


# ------------------------------------------------------------ decode step
def decode_step(params, cache, tokens, pos: int, cfg: LMConfig):
    """One decode step. tokens (B, 1), pos the shared absolute position.

    Returns (logits (B, 1, V), cache).  The cache is updated **in place**
    (the reference returns a new cache; its jit donates the old buffers to
    the same effect), so the returned dict is the one passed in.
    """
    _require_ported(cfg)
    x = embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == DENSE:
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            y, _, _ = attn.decode_self_attention(
                lp["attn"], apply_norm(lp["ln1"], x, cfg), cache["k"][i],
                cache["v"][i], pos, cfg)
            x = x + y
            x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    else:  # ssm
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            y, (nconv, nh) = ssm_mod.apply_mamba(
                lp["mamba"], apply_norm(lp["ln1"], x, cfg), cfg,
                conv_state=cache["conv"][i], ssm_state=cache["h"][i],
            )
            cache["conv"][i] = nconv
            cache["h"][i] = nh
            x = x + y
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg), cache


# ------------------------------------------------------------------- loss
def _xent_chunk(embed, xx, ll, cfg: LMConfig):
    """(sum of the chunk's token NLLs, count of its valid labels)."""
    logits = unembed(embed, xx, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = ll >= 0
    gold = torch.gather(logits, -1,
                        torch.clamp(ll, min=0).long()[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, torch.zeros((), device=lse.device))
    return torch.sum(nll), torch.sum(valid).float()


def chunked_xent(params, x, labels, cfg: LMConfig, chunk: int = 512):
    """Sequence-chunked softmax cross-entropy; never stores (B, S, V).

    ``S`` is padded to a multiple of ``chunk`` with label -1, and labels
    -1 are masked; each chunk's logits are recomputed in backward.
    """
    B, S, _ = x.shape
    chunk = max(1, min(chunk, S))
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S + pad, chunk):
        args = (params["embed"], x[:, c:c + chunk], labels[:, c:c + chunk],
                cfg)
        if remat:
            s, n = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            s, n = _xent_chunk(*args)
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, batch, cfg: LMConfig, aux_coef: float = 0.01):
    """batch: {"tokens": (B, S) int, "labels": (B, S) int (-1 = pad)}."""
    x, aux = forward(params, batch["tokens"], cfg, batch.get("vision"))
    loss = chunked_xent(params, x, batch["labels"], cfg)
    if cfg.family == MOE:
        loss = loss + aux_coef * aux
    return loss
