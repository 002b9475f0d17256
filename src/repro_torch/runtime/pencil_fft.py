"""Pencil-decomposed distributed 2-D FFT (``repro.runtime.pencil_fft``).

For optical fields too large for one card, the field's ROWS shard over
the ``model`` group of ranks and FFT2 runs as

    FFT along W (local)  ->  all-to-all row/column transpose
    -> FFT along H (local)  ->  all-to-all transpose back

the slab decomposition of distributed FFT libraries: each rank holds
(..., H/k, W) before and after, and each FFT2 moves 2 x (field bytes) x
(k-1)/k between the ranks.  The exchange is ``collectives.all_to_all``,
differentiable (its backward is the same exchange), so gradients flow
through the hops.

The supported entry point is :func:`local_spectral_pair`: the per-rank
(fft2, ifft2) pair passed as the ``spectral=`` override of
``PropagationPlan.forward``/``propagate_final``/``apply``, so every hop of
the layer loop runs the distributed FFT on row shards (``donn_steps.
make_donn_sharded_loss``, ``InferenceEngine(model_devices=...)``).  The
standalone ``pencil_fft2`` is deprecated, as in the reference.
"""
from __future__ import annotations

import warnings
from functools import partial

import torch

from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_to_all


def _local_fft2(x: torch.Tensor, *, group, k: int,
                inverse: bool) -> torch.Tensor:
    """This rank's part of the pencil FFT2 over the trailing (H/k, W) axes;
    any leading dims (batch, channel) ride along."""
    fft = torch.fft.ifft if inverse else torch.fft.fft
    h, W = x.shape[-2], x.shape[-1]
    if W % k:
        raise ValueError(f"pencil FFT: W={W} does not divide over {k} ranks")
    w = W // k
    x = fft(x, dim=-1)  # along W (full locally)
    x = x.reshape(x.shape[:-1] + (k, w)).movedim(-2, 0)  # (k, ..., h, w)
    x = all_to_all(x, group)  # slot j: rows block j, this column block
    x = x.movedim(0, -3)
    x = x.reshape(x.shape[:-3] + (k * h, w))  # (..., H, W/k)
    x = fft(x, dim=-2)  # along H (full locally)
    x = x.reshape(x.shape[:-2] + (k, h, w)).movedim(-3, 0)  # (k, ..., h, w)
    x = all_to_all(x, group)  # slot j: this row block, columns block j
    x = x.movedim(0, -2)  # (..., h, k, w)
    return x.reshape(x.shape[:-3] + (h, W))


def local_spectral_pair(group, k: int):
    """(fft2, ifft2) over row shards (..., H/k, W) of the ``k`` ranks of
    ``group``, each returning its spectrum / field in the same row-sharded
    layout, so a TF multiply takes the matching row block of the planes
    with no further exchange: the plans' ``spectral=`` override.  With one
    rank (``k == 1``, ``group`` None) it is the same passes, FFT along W
    then along H, with no exchange: the pencil FFT's plain version."""
    return (partial(_local_fft2, group=group, k=k, inverse=False),
            partial(_local_fft2, group=group, k=k, inverse=True))


def pencil_fft2(u: torch.Tensor, mesh, axis: str = "model",
                inverse: bool = False) -> torch.Tensor:
    """DEPRECATED standalone FFT2 of this rank's row block ``u`` (B, H/k, W)
    with H sharded over ``axis`` of ``mesh``.  Pass
    ``local_spectral_pair`` as the plan's ``spectral=`` override instead."""
    warnings.warn(
        "pencil_fft2/pencil_ifft2 are deprecated: pass "
        "local_spectral_pair(group, k) as the plan's spectral= override "
        "(see donn_steps.make_donn_sharded_loss)",
        DeprecationWarning, stacklevel=2,
    )
    k = shd.mesh_shape(mesh)[axis]
    return _local_fft2(u, group=mesh.get_group(axis), k=k, inverse=inverse)


def pencil_ifft2(u: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return pencil_fft2(u, mesh, axis, inverse=True)


def propagate_tf_distributed(u: torch.Tensor, h_tf: torch.Tensor, mesh,
                             axis: str = "model") -> torch.Tensor:
    """Row-sharded angular-spectrum propagation, iFFT2(FFT2(u) * H), on this
    rank's row blocks of the field ``u`` (..., H/k, W) and of the transfer
    function ``h_tf`` (H/k, W): the multiply is elementwise on the
    row-sharded spectrum, so it needs no exchange of its own."""
    k = shd.mesh_shape(mesh)[axis]
    fft2, ifft2 = local_spectral_pair(mesh.get_group(axis), k)
    return ifft2(fft2(u) * h_tf)
