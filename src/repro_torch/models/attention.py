"""Attention: GQA/MQA/MHA with a chunked online softmax, and cached decode.

Port of ``repro.models.attention`` in plain torch ops, computing what the
reference computes: the same KV chunking and padding, ``NEG_INF`` for
masked scores, probabilities multiplied by the mask, f32 scores and
accumulators (the reference's ``preferred_element_type=float32``: the
operands are upcast, so the products of bf16 values are exact and summed
in f32), and ``p_bf16`` rounding the probabilities and values to bf16
before the PV product.  ``scaled_dot_product_attention`` is not used: it
computes another function (no chunked rescaling, its own masking).

The reference's sharding hints (``constrain``) have no counterpart on one
card and are dropped.  ``cross_attention`` (vlm) attends over vision
states that may be float32 under a bf16 model, as the reference's
launcher feeds them: it computes in the promoted type where the
reference's mixed operands promote (JAX promotes ``f32 @ bf16`` to f32,
torch refuses it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import LMConfig
from repro_torch.models.layers import apply_rotary, rope_angles
from repro_torch.nn import ParamSpec

NEG_INF = -1e30


# ------------------------------------------------------------------- specs
def attention_spec(cfg: LMConfig, cross: bool = False):
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, H * Dh), torch.float32, ("embed", "heads")),
        "wk": ParamSpec((d, KV * Dh), torch.float32, ("embed", "kv_heads")),
        "wv": ParamSpec((d, KV * Dh), torch.float32, ("embed", "kv_heads")),
        "wo": ParamSpec((H * Dh, d), torch.float32, ("heads", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((H * Dh,), torch.float32, ("heads",),
                               init="zeros")
        spec["bk"] = ParamSpec((KV * Dh,), torch.float32, ("kv_heads",),
                               init="zeros")
        spec["bv"] = ParamSpec((KV * Dh,), torch.float32, ("kv_heads",),
                               init="zeros")
    if cross:
        spec["gate"] = ParamSpec((1,), torch.float32, (None,), init="zeros")
    return spec


def qkv_proj(p, x, cfg: LMConfig):
    """x (B, S, d) -> q (B,S,H,Dh), k/v (B,S,KV,Dh)."""
    dt = cfg.dtype
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (
        q.reshape(B, S, H, Dh),
        k.reshape(B, S, KV, Dh),
        v.reshape(B, S, KV, Dh),
    )


# ------------------------------------------------- chunked online softmax
def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, KV, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    chunk: int = 1024,
    kv_len: Optional[int] = None,  # valid cache length (decode)
    p_bf16: bool = False,
) -> torch.Tensor:
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    chunk = min(chunk, Skv)
    if Skv % chunk:  # pad KV to a chunk multiple; padding is masked off
        pad = chunk - Skv % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = Skv
        Skv = Skv + pad
    nchunks = Skv // chunk
    qg = (q * (Dh ** -0.5)).reshape(B, Sq, KV, G, Dh).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, Dh), dtype=torch.float32, device=dev)
    for idx in range(nchunks):
        k_c = k[:, idx * chunk:(idx + 1) * chunk]
        v_c = v[:, idx * chunk:(idx + 1) * chunk]
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_c.float())
        k_pos = idx * chunk + torch.arange(chunk, device=dev)
        allow = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            allow = allow & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            allow = allow & (k_pos[None, :] > q_pos[:, None] - window)
        if kv_len is not None:
            allow = allow & (k_pos[None, :] < kv_len)
        s = torch.where(allow, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * allow.float()
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        if p_bf16:
            pv = torch.einsum("bkgqc,bckd->bkgqd",
                              p.to(torch.bfloat16).float(),
                              v_c.to(torch.bfloat16).float())
        else:
            pv = torch.einsum("bkgqc,bckd->bkgqd", p, v_c.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]  # (B, KV, G, Sq, Dh)
    out = out.movedim(3, 1).reshape(B, Sq, H, Dh)
    return out.to(q.dtype)


def self_attention(
    p,
    x,
    cfg: LMConfig,
    positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    use_rope: bool = True,
):
    """Full training/prefill self-attention over x (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg)
    if use_rope:
        pos = (positions if positions is not None
               else torch.arange(S, device=x.device))
        cos, sin = rope_angles(cfg, pos)
        q = apply_rotary(q, cos, sin, cfg)
        k = apply_rotary(k, cos, sin, cfg)
    w = cfg.window if window is None else window
    out = chunked_attention(
        q, k, v, causal=True, window=w, chunk=cfg.attn_chunk,
        p_bf16=cfg.attn_p_bf16,
    )
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(cfg.dtype)


# ------------------------------------------------------------------ decode
def decode_self_attention(
    p,
    x,  # (B, 1, d)
    cache_k,  # (B, L, KV, Dh) — L = physical cache length
    cache_v,
    pos: int,  # current absolute position
    cfg: LMConfig,
    window: Optional[int] = None,
    use_rope: bool = True,
):
    """One-token decode against a (possibly rolling) KV cache.

    Returns (out (B, 1, d), cache_k, cache_v).  The cache tensors are
    updated **in place** (the reference returns updated copies); for
    sliding-window archs the physical cache is a rolling buffer of size
    ``window``: writes wrap (pos % L) and the mask handles relative
    positions.  A write past the end of a non-rolling cache lands in its
    last slot, as ``jax.lax.dynamic_update_slice`` clamps it.
    """
    B = x.shape[0]
    L = cache_k.shape[1]
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    pos = int(pos)
    q, k, v = qkv_proj(p, x, cfg)
    if use_rope:
        posv = torch.tensor([pos], device=dev)
        cos, sin = rope_angles(cfg, posv)
        q = apply_rotary(q, cos, sin, cfg)
        k = apply_rotary(k, cos, sin, cfg)
    w = cfg.window if window is None else window
    rolling = 0 < w <= L
    slot = pos % L if rolling else min(max(pos, 0), L - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    qg = (q * (Dh ** -0.5)).reshape(B, 1, KV, -1, Dh).float()
    s = torch.einsum("bqkgd,blkd->bkgql", qg, cache_k.float())
    idx = torch.arange(L, device=dev)
    if rolling:
        # slot i holds absolute position: largest p <= pos with p % L == i
        # (negative => the slot has never been written — mask it off)
        abs_pos = pos - torch.remainder(pos - idx, L)
    else:
        abs_pos = idx
    allow = (abs_pos >= 0) & (abs_pos <= pos)
    if w > 0:
        allow = allow & (abs_pos > pos - w)
    s = torch.where(allow, s, torch.tensor(NEG_INF, device=dev))
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,blkd->bkgqd", prob, cache_v.float())
    out = out.movedim(3, 1).reshape(B, 1, cfg.n_heads * Dh).to(x.dtype)
    return out @ p["wo"].to(cfg.dtype), cache_k, cache_v


# ----------------------------------------------------------- cross-attend
def cross_attention(p, x, vision_kv, cfg: LMConfig):
    """x (B, S, d) attends over precomputed vision states (B, Sv, d).

    Non-causal; gated with tanh(gate) (llama-3.2-vision style).  The K/V
    projections run in ``promote_types(vision_kv.dtype, cfg.dtype)``,
    the weights rounded to ``cfg.dtype`` first, as the reference's
    ``vision_kv @ wk.astype(dt)``; the output keeps ``q``'s dtype.
    """
    B, S, _ = x.shape
    dt = cfg.dtype
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ct = torch.promote_types(vision_kv.dtype, dt)
    vis = vision_kv.to(ct)
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, Dh)
    k = (vis @ p["wk"].to(dt).to(ct)).reshape(B, -1, KV, Dh)
    v = (vis @ p["wv"].to(dt).to(ct)).reshape(B, -1, KV, Dh)
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    out = out.reshape(B, S, H * Dh) @ p["wo"].to(dt)
    return out * torch.tanh(p["gate"].to(dt))
