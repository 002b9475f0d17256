"""Int8 error-feedback gradient compression (``repro.optim.compression``).

The reference's cross-``pod`` gradient mean: each block of ``BLOCK``
values is quantized to int8 with its own f32 scale (``max|x| / 127``), the
int8 blocks and the scales travel instead of the f32 values (about 4x
fewer bytes), and every rank sums the dequantized blocks of all.  Error
feedback (``ef_quantize``) keeps the quantization residual and adds it to
the next step's values.

``compressed_psum_mean`` runs over a ``torch.distributed`` group (the
reference's ``shard_map`` axis): an all-gather of the int8 blocks and the
f32 scales, then the mean of the dequantized blocks on every rank, in
rank order.  Rounding is the reference's: ``round`` half to even, as
``jnp.round``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

BLOCK = 2048


def _pad_to(x: torch.Tensor, m: int):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % m
    return torch.nn.functional.pad(flat, (0, pad)), n


def quantize_int8(x: torch.Tensor):
    """x (any shape) -> (int8 blocks (nb, BLOCK), scales (nb,), true size)."""
    flat, n = _pad_to(x.to(torch.float32), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32), n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int, shape,
                    dtype):
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def ef_quantize(x: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantize: returns (q, scale, n, new_err)."""
    comp = x.to(torch.float32) + err
    q, scale, n = quantize_int8(comp)
    deq = dequantize_int8(q, scale, n, x.shape, torch.float32)
    return q, scale, n, comp - deq


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over ``group`` (the default group when None) with an
    int8-compressed exchange: int8 blocks + f32 scales (about
    ``x.nbytes / 4 + x.nbytes / (4 * BLOCK)``) all-gathered, summed
    dequantized on every rank.  int8 travels as uint8 bytes where the
    backend has no int8 (gloo)."""
    g = dist.get_world_size(group)
    q, scale, n = quantize_int8(x)
    qs = _gather(q.view(torch.uint8), group).view(torch.int8)  # (g, nb, B)
    ss = _gather(scale, group)  # (g, nb)
    total = torch.sum(qs.to(torch.float32) * ss[..., None], dim=0)
    flat = total.reshape(-1)[:n]
    return (flat / g).reshape(x.shape).to(x.dtype)


def tree_compressed_psum_mean(tree, group=None):
    return tree_map(lambda x: compressed_psum_mean(x, group), tree)


def compression_ratio(x: torch.Tensor) -> float:
    """Achieved wire-bytes ratio vs an f32 all-reduce (per hop)."""
    q, scale, n = quantize_int8(x)
    wire = q.numel() + scale.numel() * 4
    return (n * 4) / wire
