"""Collectives of the DONN and LM meshes and the ranks that run them.

The sharded paths are SPMD programs: every rank of a
``torch.distributed`` group runs the same code on its block.  The
collectives they need, each on a group of the mesh:

- ``sum_over``: all-reduce sum whose backward is the identity.  Every rank
  of the group goes on with the same sum (the per-class logits summed over
  ``model``, the loss over ``data``) into the same loss, so each rank's
  own cotangent already is the sum's; an all-reduce in the backward would
  count it once a rank.
- ``replicated``: identity whose backward all-reduces.  A parameter held
  whole by every rank of a ``data`` group meets a different batch shard on
  each; its gradient is the sum of theirs.
- ``gather_rows``: all-gather along the row axis (-2).  Its backward keeps
  the rank's own rows of the cotangent when the gathered tensor feeds a
  computation every rank repeats alike (``reduce_grad=False``: the
  segmentation loss over whole maps), and sums the ranks' cotangents first
  when each rank goes on with other rows of it (``reduce_grad=True``: the
  resampling stitch of a heterogeneous stack).
- ``all_to_all``: the pencil FFT's exchange (``pencil_fft``); a
  permutation, so its backward is the same exchange.

The LM mesh (``repro_torch.models``, ``runtime.steps``) differentiates
each rank's share of the loss, the shares summing to the global loss, so
each collective's backward is its transpose:

- ``gather_dim``: all-gather along a dim, backward reduce-scatter (an
  FSDP weight gathered over ``data``; the residual stream entering a
  sequence-parallel block over ``model``);
- ``scatter_dim``: reduce-scatter along a dim, backward all-gather (the
  partial sums of a row-parallel projection leaving a sequence-parallel
  block);
- ``psum``: all-reduce sum whose backward is the same all-reduce (partial
  sums that every rank of the group goes on with: mamba's ``x_proj``,
  the vocab-parallel cross-entropy's sums);
- ``all_max``: an all-reduce max outside autograd.

A reduce-scatter runs as NCCL's own on a NCCL group and as an all-reduce
and a cut on gloo (whose reduce-scatter of CUDA tensors the port does not
rely on).

A group of two or more mesh axes named in another order than the mesh's
(``sharding._flat_group``) has its members' order recorded by
``set_block_order``: the gather and the reduce-scatter put block i at the
i-th of them, not at group rank i.

Each logical collective (``all_reduce_sum``, ``all_gather_dim``,
``reduce_scatter_dim``, ``exchange``, ``all_max``) reports its kind, its
bytes and its group's size once to the active cost counters
(``runtime.cost_analysis``), whatever the backend runs to carry it out;
with no counter active the report is an empty context.

Complex tensors travel as ``view_as_real`` float pairs (gloo does not take
complex ones everywhere).  Gloo also takes CUDA tensors, staged through the
host, which lets several ranks share one card.

``spawn_ranks`` runs a function on ``world`` spawned processes joined by a
file rendezvous and returns what each rank returned.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


# the active cost counters (``runtime.cost_analysis.count``)
COUNTERS: list = []
_NOT_COUNTED = contextlib.nullcontext()
# group -> its members' global ranks in block order, where that is not the
# group's own rank order (``set_block_order``)
_BLOCK_RANKS: dict = {}


def _counted(kind: str, t: torch.Tensor, group):
    """The context of one logical collective of ``kind`` on ``t`` (the
    input) over ``group``: each active counter records it once and skips
    the aten ops that carry it out."""
    if not COUNTERS:
        return _NOT_COUNTED
    stack = contextlib.ExitStack()
    size = dist.get_world_size(group)
    for c in COUNTERS:
        stack.enter_context(c.collective(kind, t, size))
    return stack


def set_block_order(group, ranks) -> None:
    """Record that block i of a gather or reduce-scatter over ``group``
    belongs to global rank ``ranks[i]`` (the group itself ranks its
    members by global rank)."""
    ranks = [int(r) for r in ranks]
    if ranks != sorted(ranks):
        _BLOCK_RANKS[group] = ranks


def block_ranks(group) -> list:
    """The global ranks of ``group`` in block order."""
    return _BLOCK_RANKS.get(group) or dist.get_process_group_ranks(group)


def _block_perm(group):
    """Group ranks in block order (None when that is the group's order)."""
    ranks = _BLOCK_RANKS.get(group)
    if ranks is None:
        return None
    by_rank = sorted(ranks)
    return [by_rank.index(r) for r in ranks]


def _block_index(group) -> int:
    ranks = _BLOCK_RANKS.get(group)
    if ranks is None:
        return dist.get_rank(group)
    return ranks.index(dist.get_rank())


def _real(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _like(buf: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(buf) if t.is_complex() else buf


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over ``group`` (None: ``t`` alone)."""
    if group is None:
        return t.clone()
    with _counted("all-reduce", t, group):
        buf = _real(t).clone()
        dist.all_reduce(buf, group=group)
        return _like(buf, t)


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in block
    order (None: ``t`` alone)."""
    if group is None:
        return t
    with _counted("all-gather", t, group):
        buf = _real(t)
        parts = [torch.empty_like(buf)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf, group=group)
        perm = _block_perm(group)
        if perm is not None:
            parts = [parts[j] for j in perm]
        return torch.cat([_like(p, t) for p in parts], dim=dim)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, cut along ``dim`` into one block a
    rank; this rank's block (None: ``t`` alone)."""
    if group is None:
        return t
    n, idx = dist.get_world_size(group), _block_index(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {n} ranks")
    size = t.shape[dim] // n
    with _counted("reduce-scatter", t, group):
        if dist.get_backend(group) == "nccl" and not t.is_complex():
            parts = t.movedim(dim, 0).contiguous()
            perm = _block_perm(group)
            if perm is not None:  # group rank r takes block perm.index(r)
                order = [perm.index(r) for r in range(n)]
                parts = parts.unflatten(0, (n, size))[order].flatten(0, 1)
            out = torch.empty((size,) + parts.shape[1:], dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, parts, group=group)
            return out.movedim(0, dim)
        return all_reduce_sum(t, group).narrow(dim, idx * size,
                                               size).contiguous()


def exchange(t: torch.Tensor, group) -> torch.Tensor:
    """All-to-all over dim 0: slot j of ``t`` goes to rank j of ``group``,
    and slot j of the result came from rank j."""
    if group in _BLOCK_RANKS:
        raise NotImplementedError("an all-to-all over mesh axes named out "
                                  "of the mesh's order")
    with _counted("all-to-all", t, group):
        buf = _real(t)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=group)
        return _like(out, t)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        ctx.rows = t.shape[-2]
        ctx.index = _block_index(group)
        return all_gather_dim(t, group, -2)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = all_reduce_sum(g, ctx.group)
        return g.narrow(-2, ctx.index * ctx.rows, ctx.rows), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(t.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.contiguous(), ctx.group, ctx.dim), None, \
            None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_dim(t.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim``, reduce-scatter backward (None: ``t``)."""
    return t if group is None else _GatherDim.apply(t, group, dim)


def scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim``, all-gather backward (None: ``t``)."""
    return t if group is None else _ScatterDim.apply(t, group, dim)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum, all-reduce backward (None: ``t``)."""
    return t if group is None else _Psum.apply(t, group)


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, outside autograd."""
    t = t.detach()
    if group is None:
        return t
    with _counted("all-reduce", t, group):
        buf = t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        return buf


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum, identity backward (see the module docstring)."""
    return t if group is None else _SumOver.apply(t, group)


def replicated(t: torch.Tensor, group) -> torch.Tensor:
    """Identity, all-reduce-sum backward (see the module docstring)."""
    return t if group is None else _Replicated.apply(t, group)


def gather_rows(t: torch.Tensor, group, reduce_grad: bool) -> torch.Tensor:
    """All-gather along dim -2 (see the module docstring)."""
    return t if group is None else _GatherRows.apply(t, group, reduce_grad)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``exchange`` with its own exchange as the backward (None: ``t``)."""
    return t if group is None else _AllToAll.apply(t, group)


# --------------------------------------------------------------------------
# Spawned ranks
# --------------------------------------------------------------------------
def _rank_entry(fn, rank, world, init_method, backend, device_type, args, q):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        q.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), *, device_type: str = "cpu",
                backend=None, timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks of one process
    group and return their results in rank order.

    The ranks meet through a file in a temporary directory.  ``backend``
    defaults to NCCL for CUDA ranks and gloo for the CPU; CUDA rank r uses
    card r modulo the cards there are (gloo ranks may share one).  A rank
    that raises, dies or is still running after ``timeout`` seconds fails
    the call with ``RuntimeError``; every rank is ended before it returns.
    """
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_entry, args=(
            fn, r, world, f"file://{tmp}/rendezvous", backend, device_type,
            args, q)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world and time.monotonic() < deadline:
                try:
                    rank, ok, val = q.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} exited without a result "
                            f"(exit codes {[procs[r].exitcode for r in dead]})"
                        ) from None
                    continue
                results[rank] = (ok, val)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = {r: v for r, (ok, v) in results.items() if not ok}
    if failed:
        raise RuntimeError("\n".join(f"rank {r} failed:\n{v}"
                                     for r, v in sorted(failed.items())))
    if len(results) < world:
        missing = sorted(set(range(world)) - set(results))
        raise RuntimeError(f"rank(s) {missing} gave no result within "
                           f"{timeout:.0f}s")
    return [results[r][1] for r in range(world)]
