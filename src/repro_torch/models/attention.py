"""Attention: GQA/MQA/MHA with a chunked online softmax, and cached decode.

Port of ``repro.models.attention`` in plain torch ops, computing what the
reference computes: the same KV chunking and padding, ``NEG_INF`` for
masked scores, probabilities multiplied by the mask, f32 scores and
accumulators (the reference's ``preferred_element_type=float32``: the
operands are upcast, so the products of bf16 values are exact and summed
in f32), and ``p_bf16`` rounding the probabilities and values to bf16
before the PV product.  ``scaled_dot_product_attention`` is not used: it
computes another function (no chunked rescaling, its own masking).

On an LM mesh (``repro_torch.runtime.sharding.context()``) training and
prefill attention enter with the whole sequence and run this rank's
query heads (``n_heads`` over ``model``) against the KV heads they group
onto: the local ``wk``/``wv`` columns when ``n_kv_heads`` divides the
model degree, else the gathered projection's heads picked per query head;
``wo`` is row-parallel and the output leaves through ``MeshContext.exit``.
Where ``n_heads`` does not divide the model degree
(``MeshContext.whole``) every ``model`` rank runs every head with
the weights gathered whole, and its whole output is cut to the rank's
block of the sequence.
Decode keeps the cache's placement: with ``kv_heads`` over ``model`` each
rank decodes its own heads as training does; with the ``head`` fallback
on ``head_dim`` it follows the reference's ``constrain`` hints: q and the
new K/V are cut to the cache's block, the scores of a ``head_dim`` block
are summed over ``model`` (the cache is never gathered), and the heads'
outputs are gathered for the row-parallel ``wo`` (or the whole ``wo``
where its rows do not divide).  ``cross_attention``
(vlm) attends over vision states that may be float32 under a bf16 model,
as the reference's launcher feeds them: it computes in the promoted type
where the reference's mixed operands promote (JAX promotes ``f32 @ bf16``
to f32, torch refuses it).  Off a mesh the same code runs on the
one-device context, whose parts are whole and collectives identities.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import LMConfig
from repro_torch.models.layers import apply_rotary, rope_angles
from repro_torch.nn import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_gather_dim, psum

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


# ------------------------------------------------------------- projections
def qkv_proj(p, x, cfg: LMConfig, kv_x=None, cross: bool = False):
    """x (B, S, d) -> q (B, S, H, Dh), k/v (B, Skv, KV, Dh), K/V from
    ``kv_x`` when given (the vision states).  On a mesh ``x`` is the whole
    sequence, q this rank's query heads and k/v the KV heads they group
    onto: this rank's KV heads when ``n_kv_heads`` divides the model
    degree, else one KV head a query head (picked from the gathered
    projection)."""
    ctx = shd.context()
    dt = cfg.dtype
    spec = attention_spec(cfg, cross=cross)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    whole = ctx.whole(H)
    h_lo, h_hi = ctx.part(H)
    m = 1 if whole else ctx.size("model")
    cols = None if whole else 1
    B, S, _ = x.shape
    kv_src = x if kv_x is None else kv_x

    def proj(src, w, b, dim):
        out = src @ ctx.model_part(p[w], spec[w], dim).to(dt).to(src.dtype)
        if cfg.qkv_bias and not cross:
            out = out + ctx.model_part(p[b], spec[b],
                                       None if dim is None else 0).to(dt)
        return out

    q = proj(x, "wq", "bq", cols).reshape(B, S, h_hi - h_lo, Dh)
    Skv = kv_src.shape[1]
    if KV % m == 0:
        k = proj(kv_src, "wk", "bk", cols).reshape(B, Skv, KV // m, Dh)
        v = proj(kv_src, "wv", "bv", cols).reshape(B, Skv, KV // m, Dh)
        return q, k, v
    G = H // KV
    idx = torch.tensor([h // G for h in range(h_lo, h_hi)], device=x.device)
    k = proj(kv_src, "wk", "bk", None).reshape(B, Skv, KV, Dh)
    v = proj(kv_src, "wv", "bv", None).reshape(B, Skv, KV, Dh)
    return q, k.index_select(2, idx), v.index_select(2, idx)


def _full_cols(ctx, x, p, w, b, spec, dt, bias: bool):
    """``x @ w (+ b)`` whole along its columns: this rank's columns, then
    all-gathered over ``model`` when ``w`` is sharded there (decode)."""
    sharded = ctx.model_sharded(spec[w], 1)
    dim = 1 if sharded else None
    out = x @ ctx.model_part(p[w], spec[w], dim).to(dt)
    if bias:
        out = out + ctx.model_part(p[b], spec[b], 0 if sharded else None
                                   ).to(dt)
    if sharded:
        out = all_gather_dim(out.contiguous(), ctx.group("model"), -1)
    return out


def _mesh_decode_out(ctx, p, qg, ck, cv, allow, cfg: LMConfig, cross=False):
    """The decode attention of the whole heads' ``qg`` (B, 1, KV, G, Dh)
    against this rank's cache blocks when ``n_kv_heads`` does not divide
    the model degree (the ``head`` fallback, or a cache held whole), as
    the reference's constraints lay it out; returns the ``wo`` product
    (B, 1, d) in the residual stream's layout: this rank's rows of ``wo``
    summed over ``model``, or the whole ``wo`` where its rows do not
    divide."""
    B = qg.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    spec = attention_spec(cfg, cross=cross)
    dev = qg.device
    qg = shd.constrain(qg, ("batch", None, "kv_heads", None, "head"))
    head_split = qg.shape[-1] != Dh
    s = torch.einsum("bqkgd,blkd->bkgql", qg.float(), ck.float())
    if head_split:  # partial scores over head_dim blocks
        s = psum(s, ctx.group("model"))
    if allow is not None:
        s = torch.where(allow, s, torch.tensor(NEG_INF, device=dev))
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,blkd->bkgqd", prob, cv.float())
    if head_split:
        o = all_gather_dim(o.contiguous(), ctx.group("model"), -1)
    o = o.movedim(3, 1).reshape(B, 1, H * Dh).to(cfg.dtype)
    lo, hi = ctx.part(H * Dh)
    wo = ctx.model_part(p["wo"], spec["wo"], 0).to(cfg.dtype)
    return ctx.exit(o[..., lo:hi] @ wo, ctx.whole(H * Dh))


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
    """Full training/prefill self-attention over x (B, S, d); on a mesh
    ``x`` and the output are the residual stream's layout."""
    ctx = shd.context()
    x = ctx.enter(x)
    q, k, v = qkv_proj(p, x, cfg)
    B, S, _ = x.shape
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
    whole = ctx.whole(cfg.n_heads)
    out = out.reshape(B, S, -1) @ ctx.model_part(
        p["wo"], attention_spec(cfg)["wo"], None if whole else 0
    ).to(cfg.dtype)
    return ctx.exit(out, whole)


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
    ctx = shd.context()
    local = KV % ctx.size("model") == 0
    if local:  # the cache holds this rank's KV heads: its heads alone
        q, k, v = qkv_proj(p, x, cfg)
        KV = k.shape[2]
    else:  # whole heads; cut to the cache's block below
        spec, dt = attention_spec(cfg), cfg.dtype
        q, k, v = (_full_cols(ctx, x, p, w, b, spec, dt, cfg.qkv_bias)
                   .reshape(B, 1, -1, Dh)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if use_rope:
        posv = torch.tensor([pos], device=dev)
        cos, sin = rope_angles(cfg, posv)
        q = apply_rotary(q, cos, sin, cfg)
        k = apply_rotary(k, cos, sin, cfg)
    w = cfg.window if window is None else window
    rolling = 0 < w <= L
    slot = pos % L if rolling else min(max(pos, 0), L - 1)
    if not local:
        kv_axes = ("batch", None, "kv_heads", "head")
        k, v = shd.constrain(k, kv_axes), shd.constrain(v, kv_axes)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

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
    qg = (q * (Dh ** -0.5)).reshape(B, 1, KV, -1, Dh).float()
    if not local:
        return _mesh_decode_out(ctx, p, qg, cache_k, cache_v, allow,
                                cfg), cache_k, cache_v
    s = torch.einsum("bqkgd,blkd->bkgql", qg, cache_k.float())
    s = torch.where(allow, s, torch.tensor(NEG_INF, device=dev))
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,blkd->bkgqd", prob, cache_v.float())
    out = out.movedim(3, 1).reshape(B, 1, -1).to(x.dtype)
    # this rank's heads through its rows of wo
    wo = ctx.model_part(p["wo"], attention_spec(cfg)["wo"], 0)
    return ctx.exit(out @ wo.to(cfg.dtype)), cache_k, cache_v


def decode_cross_attention(p, x, xk, xv, cfg: LMConfig):
    """One token's cross-attention (B, 1, d) against the cached vision K/V
    ``xk``/``xv`` (B, Sv, KV, Dh): non-causal, no rope, before the gate.
    On a mesh ``xk``/``xv`` are this rank's blocks (its KV heads, or the
    ``head`` fallback) and the output the residual stream's layout."""
    B, dt, Dh = x.shape[0], cfg.dtype, cfg.head_dim
    spec = attention_spec(cfg, cross=True)
    ctx = shd.context()
    if cfg.n_kv_heads % ctx.size("model"):
        q = _full_cols(ctx, x, p, "wq", None, spec, dt, False)
        qg = (q.reshape(B, 1, -1, Dh) * (Dh ** -0.5)).reshape(
            B, 1, cfg.n_kv_heads, -1, Dh)
        return _mesh_decode_out(ctx, p, qg, xk, xv, None, cfg, cross=True)
    q = x @ ctx.model_part(p["wq"], spec["wq"], 1).to(dt)
    qg = (q.reshape(B, 1, -1, Dh) * (Dh ** -0.5)).reshape(
        B, 1, xk.shape[2], -1, Dh)
    s = torch.einsum("bqkgd,blkd->bkgql", qg.float(), xk.float())
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,blkd->bkgqd", prob, xv.float())
    o = o.movedim(3, 1).reshape(B, 1, -1).to(dt)
    return ctx.exit(o @ ctx.model_part(p["wo"], spec["wo"], 0).to(dt))


# ----------------------------------------------------------- cross-attend
def cross_attention(p, x, vision_kv, cfg: LMConfig):
    """x (B, S, d) attends over precomputed vision states (B, Sv, d).

    Non-causal; gated with tanh(gate) (llama-3.2-vision style).  The K/V
    projections run in ``promote_types(vision_kv.dtype, cfg.dtype)``,
    the weights rounded to ``cfg.dtype`` first, as the reference's
    ``vision_kv @ wk.astype(dt)``; the output keeps ``q``'s dtype.
    """
    ctx = shd.context()
    x = ctx.enter(x)
    B, S, _ = x.shape
    dt = cfg.dtype
    ct = torch.promote_types(vision_kv.dtype, dt)
    q, k, v = qkv_proj(p, x, cfg, kv_x=vision_kv.to(ct), cross=True)
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    whole = ctx.whole(cfg.n_heads)
    wo = ctx.model_part(p["wo"], attention_spec(cfg, cross=True)["wo"],
                        None if whole else 0)
    out = ctx.exit(out.reshape(B, S, -1) @ wo.to(dt), whole)
    return out * torch.tanh(p["gate"].to(dt))
