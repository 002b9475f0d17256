"""LM model assembly: param specs, forward, decode step, loss — all six
families (port of ``repro.models.lm``).

Parameters keep the reference's tree: per-layer blocks stacked on leading
"layers" axes.  Heterogeneous families stack over periods, as the
reference scans over them:

- dense, audio, moe, ssm: ``blocks`` (n_layers, ...);
- vlm:    ``blocks`` (periods, cross_attn_period - 1, ...) self blocks and
  ``cross_blocks`` (periods, ...), one gated cross block a period;
- hybrid: ``rec_blocks`` (periods, rec-per-period, ...), ``attn_blocks``
  (periods, ...) for the pattern (rec, rec, attn), then ``tail_rec``.

Where the reference runs ``lax.scan`` over a stacked axis, the port runs a
Python loop and indexes each layer's slice (a view, no copy).  Every
stacked group may also be a list of per-layer trees (nested lists for the
two-axis groups): the train step (``repro_torch.runtime.steps``) passes
views of the stacked leaves that it differentiates layer by layer, so no
layer's gradient is scattered into a stacked-size buffer
(``stack_depths`` names each group's axes).  With ``cfg.remat`` each
block (each period for vlm and hybrid, as in the reference) runs under
``torch.utils.checkpoint`` (non-reentrant) whenever autograd records it,
the reference's ``jax.checkpoint`` of the scan body; serving under
``no_grad`` is not affected.

The loss is the reference's sequence-chunked softmax cross-entropy
(``chunked_xent``): logits are made one chunk at a time, upcast to f32,
and recomputed in backward; moe adds ``aux_coef`` times the summed
load-balancing loss.

On an LM mesh (``repro_torch.runtime.sharding.context()``) every function
runs on this rank's blocks: ``_seq_shard`` cuts the residual stream's
sequence over ``model`` where it divides (sequence parallelism; decode's
single token stays whole), each block enters and leaves through the
mesh context, ``logits_fn`` and ``decode_step`` return this rank's
``vocab`` part of the logits (all of them where the vocabulary does not
divide over ``model``), the cross-entropy is vocab-parallel (the
max, the sum of exponentials and the target logit reduced over
``model``), and ``lm_loss`` is this rank's share of the mean over the
global batch (the shares of every rank sum to the loss).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import (
    AUDIO, DENSE, HYBRID, MOE, SSM, VLM, LMConfig,
)
from repro_torch.models.layers import (
    apply_mlp, apply_norm, embed_spec, embed_tokens, mlp_spec, norm_spec,
    unembed, vocab_part,
)
from repro_torch.nn import ParamSpec, init_params
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_max, psum
from repro_torch.tree import tree_map


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
    ``i``-th entry of a per-layer list)."""
    if isinstance(blocks, list):
        return blocks[i]
    return tree_map(lambda a: a[i], blocks)


# the stacked groups of each family's tree and their count of "layers"
# axes: dense/audio/moe/ssm, vlm, hybrid without and with a tail
_LAYOUTS = {
    frozenset({"blocks"}): {"blocks": 1},
    frozenset({"blocks", "cross_blocks"}): {"blocks": 2, "cross_blocks": 1},
    frozenset({"rec_blocks", "attn_blocks"}): {"rec_blocks": 2,
                                               "attn_blocks": 1},
    frozenset({"rec_blocks", "attn_blocks", "tail_rec"}): {
        "rec_blocks": 2, "attn_blocks": 1, "tail_rec": 1},
}


def stack_depths(tree) -> dict:
    """``{group: number of leading "layers" axes}`` of an LM parameter
    tree's stacked groups (or of any tree of its structure: grads,
    moments); raises ``ValueError`` if no family stacks these groups."""
    groups = frozenset(tree) - {"embed", "final_norm"}
    if groups not in _LAYOUTS:
        raise ValueError(f"no LM family stacks the groups {sorted(groups)}")
    return _LAYOUTS[groups]


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


def moe_block_spec(cfg: LMConfig):
    return {
        "ln1": norm_spec(cfg),
        "attn": attn.attention_spec(cfg),
        "ln2": norm_spec(cfg),
        "moe": moe_mod.moe_spec(cfg),
    }


def cross_block_spec(cfg: LMConfig):
    return {
        "ln1": norm_spec(cfg),
        "xattn": attn.attention_spec(cfg, cross=True),
        "ln2": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
        "gate_ffn": ParamSpec((1,), torch.float32, (None,), init="zeros"),
    }


def ssm_block_spec(cfg: LMConfig):
    return {"ln1": norm_spec(cfg), "mamba": ssm_mod.mamba_spec(cfg)}


def rec_block_spec(cfg: LMConfig):
    return {
        "ln1": norm_spec(cfg),
        "rec": rg.rglru_spec(cfg),
        "ln2": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }


def _hybrid_counts(cfg: LMConfig):
    """(periods, rec layers a period, tail rec layers) of a hybrid cfg."""
    p = len(cfg.block_pattern)
    n_periods, tail = divmod(cfg.n_layers, p)
    n_rec_per = sum(1 for b in cfg.block_pattern if b == "rec")
    if cfg.block_pattern.count("attn") != 1 or n_rec_per != p - 1:
        raise ValueError(f"{cfg.name}: block_pattern {cfg.block_pattern} "
                         "must hold one attn and otherwise rec")
    return n_periods, n_rec_per, tail


def _vlm_counts(cfg: LMConfig):
    """(periods, self blocks a period) of a vlm cfg."""
    n_periods = cfg.n_layers // cfg.cross_attn_period
    if n_periods * cfg.cross_attn_period != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"periods of {cfg.cross_attn_period}")
    return n_periods, cfg.cross_attn_period - 1


def param_specs(cfg: LMConfig):
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg),
        "final_norm": norm_spec(cfg),
    }
    if cfg.family in (DENSE, AUDIO):
        spec["blocks"] = stack_specs(dense_block_spec(cfg), cfg.n_layers)
    elif cfg.family == MOE:
        spec["blocks"] = stack_specs(moe_block_spec(cfg), cfg.n_layers)
    elif cfg.family == SSM:
        spec["blocks"] = stack_specs(ssm_block_spec(cfg), cfg.n_layers)
    elif cfg.family == VLM:
        n_periods, self_per = _vlm_counts(cfg)
        spec["blocks"] = stack_specs(
            stack_specs(dense_block_spec(cfg), self_per), n_periods)
        spec["cross_blocks"] = stack_specs(cross_block_spec(cfg), n_periods)
    elif cfg.family == HYBRID:
        n_periods, n_rec_per, tail = _hybrid_counts(cfg)
        spec["rec_blocks"] = stack_specs(
            stack_specs(rec_block_spec(cfg), n_rec_per), n_periods)
        spec["attn_blocks"] = stack_specs(dense_block_spec(cfg), n_periods)
        if tail:
            spec["tail_rec"] = stack_specs(rec_block_spec(cfg), tail)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return spec


def init(cfg: LMConfig, gen: torch.Generator, mesh=None, rules=None):
    """Random parameters on ``gen``'s device (float32, as the reference);
    with ``mesh``, this rank's blocks, drawn leaf by leaf
    (``nn.init_params``)."""
    return init_params(param_specs(cfg), gen, mesh, rules)


def _seq_shard(x):
    """Sequence-parallel residual stream at layer boundaries: this rank's
    block of the sequence over ``model`` (the reference's
    ``constrain(x, ("batch", "seq", None))``); no-op without a mesh
    context or where S does not divide (decode's S = 1)."""
    ctx = shd.active()
    if ctx is None:
        return x
    spec = shd.operand_pspec(x.shape, ("batch", "seq", None), ctx.mesh,
                             ctx.rules)
    ctx.seq_sharded = spec[1] is not None
    return shd.constrain(x, ("batch", "seq", None))


# ---------------------------------------------------------- block applies
def _dense_block(p, x, cfg: LMConfig, window=None):
    x = x + attn.self_attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                                window=window)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _moe_block(p, x, cfg: LMConfig):
    """(x, the layer's load-balancing loss)."""
    x = x + attn.self_attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg)
    y, aux = moe_mod.apply_moe(p["moe"], apply_norm(p["ln2"], x, cfg), cfg)
    return x + y, aux


def _ssm_block(p, x, cfg: LMConfig):
    y, _ = ssm_mod.apply_mamba(p["mamba"], apply_norm(p["ln1"], x, cfg), cfg)
    return x + y


def _rec_block(p, x, cfg: LMConfig):
    y, _ = rg.apply_rglru_block(p["rec"], apply_norm(p["ln1"], x, cfg), cfg)
    x = x + y
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _gated_mlp(p, x, cfg: LMConfig):
    """The cross block's MLP residual, gated by tanh(gate_ffn)."""
    dt = cfg.dtype
    return x + torch.tanh(p["gate_ffn"].to(dt)) * apply_mlp(
        p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _cross_block(p, x, vision, cfg: LMConfig):
    x = x + attn.cross_attention(p["xattn"], apply_norm(p["ln1"], x, cfg),
                                 vision, cfg)
    return _gated_mlp(p, x, cfg)


def _vlm_period(self_p, cross_p, x, vision, cfg: LMConfig):
    """cross_attn_period - 1 self blocks, then the gated cross block."""
    for j in range(cfg.cross_attn_period - 1):
        x = _dense_block(_layer(self_p, j), x, cfg)
    return _cross_block(cross_p, x, vision, cfg)


def _hybrid_period(rec_p, attn_p, x, cfg: LMConfig):
    """The period's rec blocks, then its local-attention block."""
    for j in range(len(cfg.block_pattern) - 1):
        x = _rec_block(_layer(rec_p, j), x, cfg)
    return _dense_block(attn_p, x, cfg, window=cfg.window)


# ------------------------------------------------------------ full forward
def forward(params, tokens, cfg: LMConfig,
            vision: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (final hidden states (B, S, d) [pre-unembed], aux).

    ``aux`` is the moe layers' summed load-balancing loss (f32; zero for
    the other families; on a mesh this rank's share of it).  vlm needs
    ``vision`` (B, vision_seq, d).  On a mesh the hidden states are the
    residual stream's layout (``_seq_shard``)."""
    x = _seq_shard(embed_tokens(params["embed"], tokens, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    if fam in (DENSE, AUDIO, SSM):
        body = _maybe_remat(_ssm_block if fam == SSM else _dense_block, cfg)
        for i in range(cfg.n_layers):
            x = body(_layer(params["blocks"], i), x, cfg)
    elif fam == MOE:
        body = _maybe_remat(_moe_block, cfg)
        for i in range(cfg.n_layers):
            x, a = body(_layer(params["blocks"], i), x, cfg)
            aux = aux + a
    elif fam == VLM:
        if vision is None:
            raise ValueError("vlm forward needs vision embeddings")
        n_periods, _ = _vlm_counts(cfg)
        period = _maybe_remat(_vlm_period, cfg)
        for i in range(n_periods):
            x = period(_layer(params["blocks"], i),
                       _layer(params["cross_blocks"], i), x, vision, cfg)
    elif fam == HYBRID:
        n_periods, _, tail = _hybrid_counts(cfg)
        period = _maybe_remat(_hybrid_period, cfg)
        for i in range(n_periods):
            x = period(_layer(params["rec_blocks"], i),
                       _layer(params["attn_blocks"], i), x, cfg)
        body = _maybe_remat(_rec_block, cfg)
        for j in range(tail):
            x = body(_layer(params["tail_rec"], j), x, cfg)
    else:
        raise ValueError(f"unknown family {fam}")
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux


def logits_fn(params, tokens, cfg: LMConfig, vision=None):
    """(B, S, V) logits; on a mesh this rank's batch rows and ``vocab``
    part, the whole sequence."""
    x, _ = forward(params, tokens, cfg, vision)
    return unembed(params["embed"], shd.context().enter(x), cfg)


# ------------------------------------------------------------------ cache
def cache_specs(cfg: LMConfig, batch: int, cache_len: int):
    """ParamSpec tree (zeros) of the decode cache."""
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    ax = ("layers", "batch", None, "kv_heads", "head")

    def kv(n_layers, length):
        shape = (n_layers, batch, length, KV, Dh)
        return {"k": ParamSpec(shape, dt, ax, init="zeros"),
                "v": ParamSpec(shape, dt, ax, init="zeros")}

    if cfg.family in (DENSE, AUDIO, MOE):
        L = min(cache_len, cfg.window) if cfg.window else cache_len
        return kv(cfg.n_layers, L)
    if cfg.family == SSM:
        return {
            "conv": ParamSpec(
                (cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
                dt, ("layers", "batch", None, "mlp"), init="zeros",
            ),
            "h": ParamSpec(
                (cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
                torch.float32, ("layers", "batch", "mlp", None),
                init="zeros",
            ),
        }
    if cfg.family == VLM:
        n_periods, self_per = _vlm_counts(cfg)
        c = kv(n_periods * self_per, cache_len)
        # cross-attention K/V over the vision states, filled at prefill
        shape = (n_periods, batch, cfg.vision_seq, KV, Dh)
        c["xk"] = ParamSpec(shape, dt, ax, init="zeros")
        c["xv"] = ParamSpec(shape, dt, ax, init="zeros")
        return c
    if cfg.family == HYBRID:
        n_periods, n_rec_per, tail = _hybrid_counts(cfg)
        L = min(cache_len, cfg.window) if cfg.window else cache_len
        c = kv(n_periods, L)
        c["rec_conv"] = ParamSpec(
            (n_periods, n_rec_per, batch, cfg.d_conv - 1, cfg.lru_width),
            dt, ("layers", None, "batch", None, "mlp"), init="zeros",
        )
        c["rec_h"] = ParamSpec(
            (n_periods, n_rec_per, batch, cfg.lru_width),
            torch.float32, ("layers", None, "batch", "mlp"), init="zeros",
        )
        if tail:
            c["tail_conv"] = ParamSpec(
                (tail, batch, cfg.d_conv - 1, cfg.lru_width),
                dt, ("layers", "batch", None, "mlp"), init="zeros",
            )
            c["tail_h"] = ParamSpec(
                (tail, batch, cfg.lru_width),
                torch.float32, ("layers", "batch", "mlp"), init="zeros",
            )
        return c
    raise ValueError(f"unknown family {cfg.family}")


def init_cache(cfg: LMConfig, batch: int, cache_len: int, device=None):
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_specs(cfg, batch, cache_len),
    )


# ------------------------------------------------------------ decode step
def _decode_attn(p, x, ck, cv, pos, cfg: LMConfig, window=None):
    """Self-attention residual against the layer's cache (in place)."""
    y, _, _ = attn.decode_self_attention(
        p["attn"], apply_norm(p["ln1"], x, cfg), ck, cv, pos, cfg,
        window=window)
    return x + y


def _decode_dense_block(p, x, ck, cv, pos, cfg: LMConfig, window=None):
    x = _decode_attn(p, x, ck, cv, pos, cfg, window=window)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _decode_rec_block(p, x, conv, lru, at, cfg: LMConfig):
    """One rec block's step; its states ``conv[at]``, ``lru[at]`` are
    advanced in place."""
    y, (nconv, nh) = rg.apply_rglru_block(
        p["rec"], apply_norm(p["ln1"], x, cfg), cfg,
        conv_state=conv[at], lru_state=lru[at])
    conv[at] = nconv
    lru[at] = nh
    x = x + y
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _decode_cross_block(p, x, xk, xv, cfg: LMConfig):
    """The cross block against the cached vision K/V (non-causal, no
    rope), then its gated MLP."""
    o = attn.decode_cross_attention(p["xattn"], apply_norm(p["ln1"], x, cfg),
                                    xk, xv, cfg)
    x = x + o * torch.tanh(p["xattn"]["gate"].to(cfg.dtype))
    return _gated_mlp(p, x, cfg)


def decode_step(params, cache, tokens, pos: int, cfg: LMConfig):
    """One decode step. tokens (B, 1), pos the shared absolute position.

    Returns (logits (B, 1, V), cache).  The cache is updated **in place**
    (the reference returns a new cache; its jit donates the old buffers to
    the same effect), so the returned dict is the one passed in.  On a
    mesh the cache is this rank's blocks and the logits this rank's
    ``vocab`` part.
    """
    x = _seq_shard(embed_tokens(params["embed"], tokens, cfg))
    fam = cfg.family
    if fam in (DENSE, AUDIO, MOE):
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            if fam == MOE:
                x = _decode_attn(lp, x, cache["k"][i], cache["v"][i], pos,
                                 cfg)
                y, _ = moe_mod.apply_moe(lp["moe"],
                                         apply_norm(lp["ln2"], x, cfg), cfg)
                x = x + y
            else:
                x = _decode_dense_block(lp, x, cache["k"][i],
                                        cache["v"][i], pos, cfg)
    elif fam == SSM:
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            y, (nconv, nh) = ssm_mod.apply_mamba(
                lp["mamba"], apply_norm(lp["ln1"], x, cfg), cfg,
                conv_state=cache["conv"][i], ssm_state=cache["h"][i],
            )
            cache["conv"][i] = nconv
            cache["h"][i] = nh
            x = x + y
    elif fam == VLM:
        n_periods, self_per = _vlm_counts(cfg)
        for i in range(n_periods):
            self_p = _layer(params["blocks"], i)
            for j in range(self_per):
                li = i * self_per + j  # global self-layer index
                x = _decode_dense_block(_layer(self_p, j), x, cache["k"][li],
                                        cache["v"][li], pos, cfg)
            x = _decode_cross_block(_layer(params["cross_blocks"], i), x,
                                    cache["xk"][i], cache["xv"][i], cfg)
    elif fam == HYBRID:
        n_periods, n_rec_per, tail = _hybrid_counts(cfg)
        for i in range(n_periods):
            rec_p = _layer(params["rec_blocks"], i)
            for j in range(n_rec_per):
                x = _decode_rec_block(_layer(rec_p, j), x, cache["rec_conv"],
                                      cache["rec_h"], (i, j), cfg)
            x = _decode_dense_block(_layer(params["attn_blocks"], i), x,
                                    cache["k"][i], cache["v"][i], pos, cfg,
                                    window=cfg.window)
        for j in range(tail):
            x = _decode_rec_block(_layer(params["tail_rec"], j), x,
                                  cache["tail_conv"], cache["tail_h"], j,
                                  cfg)
    else:
        raise ValueError(f"unknown family {fam}")
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg), cache


# ------------------------------------------------------------------- loss
def _xent_chunk(embed, xx, ll, cfg: LMConfig):
    """(sum of the chunk's token NLLs, count of its valid labels)."""
    logits = unembed(embed, xx, cfg).float()
    valid = ll >= 0
    # vocab-parallel on a mesh: the logits hold this rank's part, and the
    # max, the sum of exponentials and the target logit are reduced over
    # model (torch.logsumexp's own formula); a vocabulary that does not
    # divide is whole on every rank, reduced over nothing
    ctx = shd.context()
    g = None if ctx.whole(cfg.vocab) else ctx.group("model")
    lo, hi = vocab_part(cfg)
    m = all_max(logits.amax(dim=-1), g)
    lse = torch.log(psum(torch.exp(logits - m[..., None]).sum(dim=-1), g)) + m
    lab = ll.long() - lo
    mine = (lab >= 0) & (lab < hi - lo)
    own = torch.gather(logits, -1,
                       torch.clamp(lab, 0, hi - lo - 1)[..., None])[..., 0]
    gold = psum(torch.where(mine, own, torch.zeros((), device=own.device)), g)
    nll = torch.where(valid, lse - gold, torch.zeros((), device=lse.device))
    return torch.sum(nll), torch.sum(valid).float()


def chunked_xent(params, x, labels, cfg: LMConfig, chunk: int = 512):
    """Sequence-chunked softmax cross-entropy; never stores (B, S, V).

    ``S`` is padded to a multiple of ``chunk`` with label -1, and labels
    -1 are masked; each chunk's logits are recomputed in backward.  On a
    mesh ``x`` is the residual stream's layout and the result is this
    rank's share of the mean over the global batch.
    """
    ctx = shd.context()
    x = ctx.enter(x)
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
    return tot / torch.clamp(ctx.data_sum(cnt), min=1.0) / ctx.copies()


def lm_loss(params, batch, cfg: LMConfig, aux_coef: float = 0.01):
    """batch: {"tokens": (B, S) int, "labels": (B, S) int (-1 = pad)}.

    On a mesh: this rank's share of the loss (``chunked_xent``; the aux
    term's share from ``moe.apply_moe``)."""
    x, aux = forward(params, batch["tokens"], cfg, batch.get("vision"))
    loss = chunked_xent(params, x, batch["labels"], cfg)
    if cfg.family == MOE:
        loss = loss + aux_coef * aux
    return loss
