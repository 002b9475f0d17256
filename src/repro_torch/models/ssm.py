"""Mamba-1 selective-SSM block (falcon-mamba-7b), port of ``repro.models.ssm``.

Training and prefill run the reference's chunked sequential scan
(``_selective_scan``) step by step in torch ops: the same padding to a
chunk multiple and the same per-step discretization ``exp(dt A)``,
``dt x B``; the (B, S, d_inner, state) tensor is never materialized, and
under autograd each chunk is recomputed in backward (the reference's
``jax.checkpoint`` per chunk).  Decode keeps
(conv_state, ssm_state) and advances one step.  As in the reference, the
served block runs this plain scan; the hand-written K7 kernel
(``kernels.ops.selective_scan``) is held against it.

On an LM mesh (``repro_torch.runtime.sharding.context()``) ``d_inner``
(``mlp``) is split over ``model``: the block enters with the whole
sequence, gathers its block of ``in_proj``'s outputs over ``model`` and
takes its channels of both halves, runs the conv, the scan and ``D`` on
them, sums ``x_proj``'s partial products over ``model`` before ``dt``,
``B`` and ``C``, and leaves through the row-parallel ``out_proj``.
Decode states are the rank's channels.  A ``d_inner`` that does not divide
over ``model`` (``MeshContext.whole``) runs whole on every ``model`` rank,
as the reference replicates it: every weight and state whole, no sum
over ``model``, the output whole.  Off a mesh the same code runs on
the one-device context, whose parts are whole and collectives identities.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import gather_dim


def mamba_spec(cfg: LMConfig):
    d, di, st, dr, dc = (
        cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.d_conv,
    )
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((d, 2 * di), f32, ("embed", "mlp")),
        "conv_w": ParamSpec((dc, di), f32, (None, "mlp"), init="normal",
                            scale=0.5),
        "conv_b": ParamSpec((di,), f32, ("mlp",), init="zeros"),
        "x_proj": ParamSpec((di, dr + 2 * st), f32, ("mlp", None)),
        "dt_w": ParamSpec((dr, di), f32, (None, "mlp")),
        "dt_b": ParamSpec((di,), f32, ("mlp",), init="normal", scale=0.1),
        "A_log": ParamSpec((di, st), f32, ("mlp", None), init="s4d_a_log"),
        "D": ParamSpec((di,), f32, ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), f32, ("mlp", "embed")),
    }


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over S. x: (B, S, di), w: (dc, di).

    If ``state`` (B, dc-1, di) is given (decode), it prefixes x.
    Returns (y, new_state).
    """
    dc = w.shape[0]
    if state is not None:
        xx = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xx = F.pad(x, (0, 0, dc - 1, 0))
    S = x.shape[1]
    y = sum(xx[:, i:i + S, :] * w[i].to(x.dtype) for i in range(dc))
    new_state = xx[:, -(dc - 1):, :] if dc > 1 else None
    return y + b.to(x.dtype), new_state


def _scan_chunk(h, dt, xc, Bs, Cs, A):
    """Steps of one chunk: (h after them, y (B, chunk, di))."""
    ys = []
    # unbind: one backward op a chunk stacks the steps' grads (indexing
    # each step would scatter each into a zero tensor of the chunk)
    for dt_t, x_t, B_t, C_t in zip(dt.unbind(1), xc.unbind(1), Bs.unbind(1),
                                   Cs.unbind(1)):
        dA = torch.exp(dt_t[..., None] * A)  # (B, di, st)
        h = dA * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, C_t))
    return h, torch.stack(ys, dim=1)


def _selective_scan(dt, Bs, Cs, xc, A, h0, chunk: int):
    """h_t = exp(dt A) h_{t-1} + dt B_t x_t ;  y_t = (C_t . h_t).

    dt, xc: (B, S, di); Bs, Cs: (B, S, st); A: (di, st); h0: (B, di, st).
    Returns (y (B, S, di) float32, h_final).

    Under autograd each chunk of steps runs in ``torch.utils.checkpoint``
    (non-reentrant), the reference's ``jax.checkpoint`` of ``chunk_body``:
    backward keeps only the chunk-boundary states and recomputes the
    steps of one chunk at a time.  The values are the plain loop's, bit
    for bit.
    """
    B, S, di = xc.shape
    chunk = max(1, min(chunk, S))
    pad = (-S) % chunk
    if pad:  # padded steps have dt = 0: exp(0) = 1 keeps h unchanged
        dt, xc, Bs, Cs = (F.pad(a, (0, 0, 0, pad)) for a in (dt, xc, Bs, Cs))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, Bs, Cs, xc, A, h0))
    h = h0
    ys = []
    for c in range(0, S + pad, chunk):
        args = (h, dt[:, c:c + chunk], xc[:, c:c + chunk],
                Bs[:, c:c + chunk], Cs[:, c:c + chunk], A)
        if remat:
            h, y = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            h, y = _scan_chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def mamba_scan_inputs(p, x, cfg: LMConfig,
                      conv_state: Optional[torch.Tensor] = None):
    """The block up to its scan: (xc, dt, B, C, A, z, new_conv_state).

    xc, dt (B, S, di) and B, C (B, S, st) are float32, A = -exp(A_log)
    (di, st); z is the gate half of the input projection.  On a mesh ``x``
    is the whole sequence and every ``di`` this rank's channels: its block
    of ``in_proj``'s columns is gathered over ``model`` as activations, not
    weights, and ``x_proj``'s partial products are summed over ``model``;
    all of ``di`` where it does not divide (``MeshContext.whole``).
    """
    di, st, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dt_ = cfg.dtype
    ctx = shd.context()
    spec = mamba_spec(cfg)

    def w(name, dim=None):
        return ctx.model_part(p[name], spec[name], dim)

    whole = ctx.whole(di)
    lo, hi = ctx.part(di)
    cols = ctx.model_sharded(spec["in_proj"], 1)
    xz = x @ w("in_proj", 1 if cols else None).to(dt_)
    if cols:  # this rank's block of the columns, gathered as activations
        xz = gather_dim(xz, ctx.group("model"), -1)
    x_in, z = xz[..., lo:hi], xz[..., di + lo:di + hi]
    y_conv, new_conv = _causal_conv(x_in, w("conv_w", 1), w("conv_b", 0),
                                    state=conv_state)
    xc = F.silu(y_conv).float()
    proj = xc.to(dt_) @ w("x_proj", 0).to(dt_)
    if not whole:
        proj = ctx.psum_model(proj)
    dt_low = proj[..., :dr].float()
    B_ssm = proj[..., dr:dr + st].float()
    C_ssm = proj[..., dr + st:].float()
    dt = F.softplus(dt_low @ w("dt_w", 1).float() + w("dt_b", 0))
    A = -torch.exp(w("A_log", 0))  # (di, st)
    return xc, dt, B_ssm, C_ssm, A, z, new_conv


def apply_mamba(
    p,
    x,
    cfg: LMConfig,
    conv_state: Optional[torch.Tensor] = None,
    ssm_state: Optional[torch.Tensor] = None,
):
    """x: (B, S, d).  Returns (out, (new_conv_state, new_ssm_state)).

    Pass states for incremental decode (S may be 1); states are None for
    prefill (zero-initialized here).  On a mesh ``x`` and ``out`` are the
    residual stream's layout and the states this rank's channels.
    """
    ctx = shd.context()
    spec = mamba_spec(cfg)
    x = ctx.enter(x)
    B = x.shape[0]
    xc, dt, B_ssm, C_ssm, A, z, new_conv = mamba_scan_inputs(
        p, x, cfg, conv_state)
    h0 = (ssm_state if ssm_state is not None
          else torch.zeros((B, xc.shape[-1], cfg.ssm_state),
                           dtype=torch.float32, device=x.device))
    y, h = _selective_scan(dt, B_ssm, C_ssm, xc, A, h0, cfg.scan_chunk)
    y = y + ctx.model_part(p["D"], spec["D"], 0) * xc
    y = y.to(cfg.dtype) * F.silu(z)
    out = y @ ctx.model_part(p["out_proj"], spec["out_proj"], 0).to(cfg.dtype)
    return ctx.exit(out, ctx.whole(cfg.d_inner)), (new_conv, h)
