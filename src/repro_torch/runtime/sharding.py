"""Logical-axis sharding rules for the DONN and LM meshes
(``repro.runtime.sharding``).

Parameters and activations carry *logical* axis names
(``repro_torch.nn.ParamSpec``); a rules table maps them to the axes of the
2-D ``("data", "model")`` mesh.  The port runs SPMD under
``torch.distributed``: one process a rank, each holding its own block of
every sharded tensor.  A spec here is a plain tuple, one entry a dim —
``None`` (replicated), a mesh-axis name or a tuple of names — equal to
``tuple(P(...))`` of the reference's ``PartitionSpec``.

The rule functions read only ``mesh.shape`` as a name -> size mapping
(``mesh_shape``), so any object with such a ``shape`` stands in for a mesh
where no rank runs; a ``torch.distributed`` ``DeviceMesh`` (tuple shape
plus ``mesh_dim_names``) is read the same way.

``local_block`` cuts this rank's block of a global tensor by its spec: the
counterpart of placing an array with a ``NamedSharding``; ``local_tree``
and ``gather_tree`` do so for a tree and back.

The LM helpers keep the reference's names: ``spec_sharding``,
``tree_shardings``, ``batch_sharding`` and ``scalar_sharding`` return
spec tuples (the port's placement), ``abstract_like`` meta tensors and
``sharded_zeros`` this rank's zero blocks.  ``activation_sharding(mesh)``
puts a ``MeshContext`` in force for the LM models (its mesh, groups and
this rank's coordinates; ``active()`` reads it) and ``constrain`` cuts a
whole tensor to this rank's block of its logical axes, a no-op without
it, as in the reference.
"""
from __future__ import annotations

import math
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


class ShardingRulesError(ValueError):
    """A rules table maps conflicting logical axes onto one mesh axis.

    Raised (rather than silently picking a winner) when ``batch`` and
    ``field_h`` — the two axes that define the 2-D ``(data, model)``
    layout — claim the same mesh axis: every rank would see a different
    row block of a different batch shard, and the sums over ``model``
    would be silently wrong.
    """


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": "model",
    "embed": ("data", "pod"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head": "model",
    "mlp": "model",
    "expert": "model",
    "channel": None,
    "layers": None,
    "field_h": None,
    "field_w": "model",
    "population": ("pod", "data"),
    "classes": None,
}


def donn_rules(*, data="data", model="model") -> dict:
    """The DONN rules table of the 2-D ``(data, model)`` mesh, shared by
    training (``donn_steps.make_donn_sharded_loss``) and serving
    (``InferenceEngine(model_devices=...)``):

      batch / population -> (pod, data)   data parallel
      field_h            -> model         spatial rows (pencil FFT)
      field_w / channel  -> replicated    (W is the locally-full FFT axis)

    Validated by :func:`check_rules`.
    """
    return check_rules({
        **DEFAULT_RULES,
        "batch": ("pod", data),
        "population": ("pod", data),
        "field_h": model,
        "field_w": None,
    })


def _flat_axes(axes) -> tuple:
    return () if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes)
    )


def check_rules(rules: Mapping[str, Any]) -> Mapping[str, Any]:
    """Typed validation of a rules table: batch/field_h must not collide."""
    overlap = (set(_flat_axes(rules.get("batch")))
               & set(_flat_axes(rules.get("field_h"))))
    if overlap:
        raise ShardingRulesError(
            f"'batch' and 'field_h' both map onto mesh axis "
            f"{sorted(overlap)[0]!r}: the data and spatial layouts would "
            f"alias — give each its own mesh axis (see make_mesh_2d)"
        )
    return rules


def spatial_rules(axis: str = "model") -> dict:
    """Row-sharded DONN layout: fields, TF planes and phases sharded along
    H (``field_h``) over ``axis``; ``field_w`` replicated (the locally-full
    axis between the pencil FFT's transposes)."""
    return {**DEFAULT_RULES, "field_h": axis, "field_w": None}


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a stand-in whose
    ``shape`` already is that mapping."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def world_size() -> int:
    """Ranks of the default process group, or the ``WORLD_SIZE`` that
    ``make_mesh_2d`` would initialise it with (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh_2d(data: int = 1, model: int = 1, *, device=None,
                 backend: Optional[str] = None):
    """The 2-D ``(data, model)`` ``DeviceMesh`` every DONN consumer uses.

    ``data`` x ``model`` ranks: batch over ``data``, field rows over
    ``model`` (``make_device_mesh``).
    """
    return make_device_mesh((data, model), ("data", "model"), device=device,
                            backend=backend)


def make_device_mesh(shape, axes, *, device=None,
                     backend: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the named ``axes`` spanning every
    rank of the process group (SPMD: every rank runs the same program on
    its block).

    Without a process group one is initialised from the environment
    (``env://``: ``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``), or, for a
    mesh of one rank with no such environment, as a group of this one
    process.  ``backend`` defaults to NCCL for a CUDA ``device`` and gloo
    for the CPU (gloo ranks may share one card).
    """
    shape = tuple(int(n) for n in shape)
    need = math.prod(shape)
    have = world_size()
    what = " x ".join(f"{n} {a}" for n, a in zip(shape, axes))
    if need > have:
        raise ValueError(f"a mesh of {need} ranks ({what}) needs {need} "
                         f"ranks, have {have}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    if need != dist.get_world_size():
        raise ValueError(
            f"a mesh of {what} must span every rank of the process group "
            f"({dist.get_world_size()})"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))


def _axis_size(shape: Mapping, axes) -> int:
    if axes is None:
        return 1
    size = 1
    for a in _flat_axes(axes):
        if a not in shape:
            return 0  # axis not present in this mesh -> unmappable
        size *= shape[a]
    return size


def present_axes(mesh, axes):
    """Rule axes (a name or tuple) filtered down to the mesh's axes."""
    if axes is None:
        return None
    shape = mesh_shape(mesh)
    if isinstance(axes, str):
        return axes if axes in shape else None
    kept = tuple(a for a in axes if a in shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _check_batch_field_collision(logical_axes, mesh, rules) -> None:
    """Typed error when batch and field_h resolve onto one mesh axis."""
    names = [n for n in logical_axes if n]
    if "batch" not in names or "field_h" not in names:
        return
    b = set(_flat_axes(present_axes(mesh, rules.get("batch"))))
    h = set(_flat_axes(present_axes(mesh, rules.get("field_h"))))
    if b & h:
        raise ShardingRulesError(
            f"'batch' and 'field_h' both resolve to mesh axis "
            f"{sorted(b & h)[0]!r} on {tuple(mesh_shape(mesh).values())}: "
            f"refusing to silently pick a winner — fix the rules table "
            f"(donn_rules gives batch->data, field_h->model)"
        )


def rules_pspec(logical_axes: Sequence[Optional[str]],
                rules: Optional[Mapping[str, Any]] = None,
                mesh=None) -> tuple:
    """Logical axis names -> spec through the rules table, full rank, no
    divisibility fallback; a mesh axis claimed by two dims raises
    :class:`ShardingRulesError`.  With ``mesh`` given, rule axes absent
    from it drop to replicated."""
    rules = rules or DEFAULT_RULES
    out, used = [], set()
    for name in logical_axes:
        axes = rules.get(name) if name else None
        if mesh is not None:
            axes = present_axes(mesh, axes)
        flat = _flat_axes(axes)
        dup = sorted(set(flat) & used)
        if dup:
            raise ShardingRulesError(
                f"mesh axis {dup[0]!r} claimed by more than one logical "
                f"axis in {tuple(logical_axes)}"
            )
        used.update(flat)
        out.append(axes if flat else None)
    return tuple(out)


def dim0_pspec(axes, ndim: int) -> tuple:
    """Spec sharding dim 0 over ``axes``, rest replicated."""
    if not _flat_axes(axes):
        return (None,) * ndim
    return (axes,) + (None,) * (ndim - 1)


def replicated_pspec(ndim: int = 0) -> tuple:
    return (None,) * ndim


def with_leading(spec: Sequence, lead: int = 1) -> tuple:
    """Shift a spec right of ``lead`` unsharded leading axes (chunk dims)."""
    return (None,) * lead + tuple(spec)


def resolve_pspec(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
                  mesh, rules: Optional[Mapping[str, Any]] = None) -> tuple:
    """Map logical axes to mesh axes; drop non-divisible or duplicate uses.

    A mesh axis is consumed at most once per array (first dim wins); a dim
    not divisible by its axes' extent replicates.  ``batch`` and
    ``field_h`` on one mesh axis raise :class:`ShardingRulesError`.
    Trailing replicated dims are trimmed, as the reference's spec is.
    """
    rules = rules or DEFAULT_RULES
    _check_batch_field_collision(logical_axes, mesh, rules)
    sizes = mesh_shape(mesh)
    out, used = [], set()
    for dim, name in zip(shape, logical_axes):
        axes = present_axes(mesh, rules.get(name)) if name else None
        if axes is not None and any(a in used for a in _flat_axes(axes)):
            axes = None
        size = _axis_size(sizes, axes) if axes else 1
        if axes is None or size <= 1 or dim % size != 0:
            out.append(None)  # replicate: unmapped, non-divisible, or dup
        else:
            out.append(axes)
            used.update(_flat_axes(axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def operand_pspec(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
                  mesh, rules: Optional[Mapping[str, Any]] = None) -> tuple:
    """:func:`resolve_pspec` without the trailing-None trim: full rank,
    with the divisibility fallback (the (L, 1, 1) int8 plane scales of a
    row-sharded frozen stack replicate)."""
    spec = resolve_pspec(shape, logical_axes, mesh, rules)
    return spec + (None,) * (len(tuple(shape)) - len(spec))


def tree_pspecs(specs, mesh, rules=None):
    """A ``ParamSpec`` tree -> the tree of its resolved specs (tuples)."""
    return tree_map(lambda s: resolve_pspec(
        s.shape, s.logical_axes or (None,) * len(s.shape), mesh, rules),
        specs)


def batch_pspec(mesh, ndim: int, rules=None,
                batch_size: Optional[int] = None) -> tuple:
    """Dim 0 (the global batch) over the DP axes, the rest replicated.

    With ``batch_size``, axes are dropped right to left until the rest
    divides it (a batch of 1 replicates): the reference's
    ``batch_sharding``.
    """
    rules = rules or DEFAULT_RULES
    flat = _flat_axes(present_axes(mesh, rules.get("batch")))
    if batch_size is not None:
        sizes = mesh_shape(mesh)
        while flat and batch_size % _axis_size(sizes, flat) != 0:
            flat = flat[:-1]
    if not flat:
        return (None,) * ndim
    return dim0_pspec(flat if len(flat) > 1 else flat[0], ndim)


# --------------------------------------------------------------------------
# Blocks of this rank
# --------------------------------------------------------------------------
def axes_index(mesh, axes) -> tuple:
    """(index, count): this rank's position along ``axes`` (row-major over
    the named axes, as a tuple spec shards a dim) and their extent."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, count = 0, 1
    for a in _flat_axes(axes):
        idx = idx * sizes[a] + coord[a]
        count *= sizes[a]
    return idx, count


def local_block(t, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec``: every
    sharded dim cut to the rank's slice (a view).  A dim that does not
    divide over its axes stays whole, as ``resolve_pspec`` replicates it."""
    t = torch.as_tensor(t)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx, count = axes_index(mesh, axes)
        if t.shape[dim] % count:
            continue
        size = t.shape[dim] // count
        t = t.narrow(dim, idx * size, size)
    return t


def axes_group(mesh, axes):
    """The process group of the ranks that differ only along ``axes``: the
    named axis's group when one of them holds more than one rank, the
    whole world when they cover every axis of the mesh in its order (it
    spans the world, a 1x1 mesh too), None when none holds more than one
    rank (this rank alone), else the group of those axes flattened in the
    order named (``_flat_group``)."""
    sizes = mesh_shape(mesh)
    flat = _flat_axes(axes)
    wide = tuple(a for a in flat if sizes.get(a, 1) > 1)
    if len(wide) == 1:
        return mesh.get_group(wide[0])
    if set(flat) >= set(sizes) and wide == tuple(
            a for a, n in sizes.items() if n > 1):
        return dist.group.WORLD
    if not wide:
        return None
    return _flat_group(mesh, wide)


def _flat_group(mesh, axes: tuple):
    """The group of the ranks that differ only along ``axes`` (two or more
    of the mesh's axes), its blocks in ``axes_index``'s order for this
    order of the names: block i of a gather or a reduce-scatter over it is
    the rank at index i.

    ``dist.new_group`` ranks a group's members by global rank, which is
    that order only when the names come in the mesh's order (``("pod",
    "data")``); for another order (``("data", "pod")``, the FSDP rule)
    ``collectives.set_block_order`` records the members' order, and the
    collectives put each block in its place.  Every rank creates every
    group of the tuple in the same order (``new_group`` is collective), one
    group a tuple of names, cached on the mesh.
    """
    from repro_torch.runtime.collectives import set_block_order

    cache = mesh.__dict__.setdefault("_repro_flat_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        perm = ([i for i, a in enumerate(names) if a not in axes]
                + [names.index(a) for a in axes])
        count = group_count(mesh, axes)
        me = dist.get_rank()
        # the rank grid outside any dispatch mode (a dry-run trace may be
        # counting, on fake tensors)
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            grid = np.array(mesh.mesh.tolist())
        for ranks in grid.transpose(perm).reshape(-1, count).tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                set_block_order(group, ranks)
                cache[axes] = group
    return cache[axes]


def group_count(mesh, axes) -> int:
    """Ranks along ``axes`` (1 when none of them is in the mesh)."""
    sizes = mesh_shape(mesh)
    return math.prod(sizes.get(a, 1) for a in _flat_axes(axes))


# --------------------------------------------------------------------------
# The LM helpers (``repro.runtime.sharding``'s spec_sharding ... sharded_zeros)
# --------------------------------------------------------------------------
def spec_sharding(spec, mesh, rules=None) -> tuple:
    """A ``ParamSpec``'s placement on ``mesh``: its resolved spec tuple
    (the reference's ``NamedSharding``)."""
    axes = spec.logical_axes or (None,) * len(spec.shape)
    return resolve_pspec(spec.shape, axes, mesh, rules)


def tree_shardings(specs, mesh, rules=None):
    """A ``ParamSpec`` tree -> the tree of its placements (spec tuples)."""
    return tree_map(lambda s: spec_sharding(s, mesh, rules), specs)


def batch_sharding(mesh, ndim: int, rules=None,
                   batch_size: Optional[int] = None) -> tuple:
    """The reference's ``batch_sharding``: :func:`batch_pspec`."""
    return batch_pspec(mesh, ndim, rules, batch_size)


def scalar_sharding(mesh) -> tuple:
    """A scalar's placement: replicated on every rank."""
    return ()


def abstract_like(specs):
    """ParamSpec tree -> tree of meta tensors of the specs' shapes and
    dtypes (stand-ins that hold no memory)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` leaf under ``spec``
    (``local_block``'s: a dim that does not divide stays whole)."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        count = group_count(mesh, axes)
        if axes is not None and out[dim] % count == 0:
            out[dim] //= count
    return tuple(out)


def sharded_zeros(specs, mesh, rules=None, device=None):
    """This rank's zero blocks of a ``ParamSpec`` tree on ``mesh``."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(
        block_shape(s.shape, spec_sharding(s, mesh, rules), mesh),
        dtype=s.dtype, device=dev), specs)


def local_tree(tree, pspecs, mesh, device=None):
    """This rank's block of every leaf of a global tree under the spec
    tree ``pspecs``, as contiguous copies (on ``device`` if given)."""
    def cut(t, spec):
        b = local_block(t, spec, mesh)
        b = b.to(device) if device is not None else b
        return b.clone(memory_format=torch.contiguous_format)
    return tree_map(cut, tree, pspecs)


def gather_leaf(t, spec, mesh) -> torch.Tensor:
    """The global tensor of this rank's block ``t`` of a leaf: each sharded
    dim all-gathered over its axes (a collective: every rank calls it)."""
    from repro_torch.runtime.collectives import all_gather_dim

    for dim, axes in enumerate(spec):
        if axes is not None:
            t = all_gather_dim(t.contiguous(), axes_group(mesh, axes), dim)
    return t


def gather_tree(tree, pspecs, mesh):
    """The global leaves of a sharded tree, on every rank, leaf by leaf in
    tree order."""
    return tree_map(lambda t, s: gather_leaf(t, s, mesh), tree, pspecs)


def replicated_axes(spec, mesh) -> tuple:
    """The mesh axes (of size > 1) a leaf of ``spec`` is replicated over,
    in the mesh's order."""
    used = {a for axes in spec for a in _flat_axes(axes)}
    return tuple(a for a, n in mesh_shape(mesh).items()
                 if n > 1 and a not in used)


# --------------------------------------------------------------------------
# The mesh of an LM step.  Model code reads it through ``context()``: off
# a mesh that is the one-device context, so the models keep one code path.
# --------------------------------------------------------------------------
class MeshContext:
    """An LM step's mesh, its groups, this rank's coordinates, and the
    placement of the step's activations: ``batch_sharded`` (the batch dim
    of every input is this rank's block over ``data``; else each ``data``
    rank holds the whole batch) and ``seq_sharded`` (the residual stream
    between layers is this rank's block of the sequence over ``model``,
    set by ``lm.forward`` through ``_seq_shard``).

    The step differentiates each rank's share of the loss: a value that
    ``k`` ranks hold alike enters the loss divided by ``k``
    (``loss_share``), every collective's backward is its transpose
    (``repro_torch.runtime.collectives``), and a parameter held whole by
    several ranks gets the sum of their gradients (``steps``).

    ``mesh=None`` is one device (``context()`` off a mesh): every group is
    None, every part whole, ``enter``/``exit`` the identity."""

    def __init__(self, mesh=None, rules=None, batch_sharded: bool = True):
        self.mesh = mesh
        self.rules = rules or DEFAULT_RULES
        self.sizes = {} if mesh is None else mesh_shape(mesh)
        self.coord = ({} if mesh is None else
                      dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())))
        self.batch_sharded = batch_sharded
        self.seq_sharded = False
        self._groups = {a: axes_group(mesh, a) if n > 1 else None
                        for a, n in self.sizes.items()}

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coord.get(axis, 0)

    def group(self, axis: str):
        """The axis's process group (None when it holds one rank)."""
        return self._groups.get(axis)

    def spec(self, pspec) -> tuple:
        """A ``ParamSpec``'s placement, one entry a dim (full rank)."""
        axes = pspec.logical_axes or (None,) * len(pspec.shape)
        if self.mesh is None:
            return (None,) * len(axes)
        return operand_pspec(pspec.shape, axes, self.mesh, self.rules)

    def whole(self, n: int) -> bool:
        """True where ``n`` does not divide over ``model``.  A block whose
        model-sharded dim (heads, ``mlp`` columns, vocabulary, ``d_inner``,
        experts) is ``n`` then runs whole on every ``model`` rank: its
        weights whole (``resolve_pspec`` replicates the dim, ``model_part``
        gathers any other), its output whole (``exit(y, whole=True)``), as
        the reference replicates a dim that does not divide."""
        return n % self.size("model") != 0

    def part(self, n: int) -> tuple:
        """(lo, hi): this rank's contiguous part of ``n`` over ``model``;
        all of it where ``n`` does not divide (``whole``)."""
        if self.whole(n):
            return 0, n
        size = n // self.size("model")
        lo = self.index("model") * size
        return lo, lo + size

    def model_part(self, t, pspec, dim: Optional[int] = None):
        """The compute view of a parameter block ``t`` (its spec from
        ``pspec``): whole along every dim but ``dim``, which is this rank's
        part over ``model``.  A dim sharded over ``data`` is gathered over
        it (FSDP), one sharded over ``model`` is gathered unless it is
        ``dim``; ``dim`` held whole is cut to this rank's part."""
        from repro_torch.runtime.collectives import gather_dim

        spec = self.spec(pspec)
        for d, axes in enumerate(spec):
            if axes is None or (d == dim and axes == "model"):
                continue
            t = gather_dim(t, axes_group(self.mesh, axes), d)
        if dim is not None and spec[dim] != "model":
            lo, hi = self.part(t.shape[dim])
            if hi - lo < t.shape[dim]:
                t = t.narrow(dim, lo, hi - lo)
        return t

    def model_sharded(self, pspec, dim: int) -> bool:
        return self.spec(pspec)[dim] == "model"

    def enter(self, x):
        """The residual stream -> the whole sequence, to enter a block."""
        from repro_torch.runtime.collectives import gather_dim

        return gather_dim(x, self.group("model"), 1) if self.seq_sharded \
            else x

    def exit(self, y, whole: bool = False):
        """A block's partial sums over ``model`` (whole sequence) -> the
        residual stream: reduce-scattered over the sequence, or summed.
        A ``whole`` output (every rank the same sum) is cut to this rank's
        block of the sequence, or kept."""
        from repro_torch.runtime.collectives import psum, scatter_dim

        g = self.group("model")
        if g is None:
            return y
        if whole:
            if not self.seq_sharded:
                return y
            lo, hi = self.part(y.shape[1])
            return y[:, lo:hi]
        dt = y.dtype
        y = y.float()  # partial sums add in f32
        y = scatter_dim(y, g, 1) if self.seq_sharded else psum(y, g)
        return y.to(dt)

    def psum_model(self, t):
        """Partial products summed over ``model`` (in f32)."""
        from repro_torch.runtime.collectives import psum

        g = self.group("model")
        if g is None:
            return t
        return psum(t.float(), g).to(t.dtype)

    def copies(self) -> int:
        """Ranks that hold one data shard's loss alike: the ``model`` ranks,
        times the ``data`` ranks when the batch is not split."""
        return self.size("model") * (1 if self.batch_sharded
                                     else self.size("data"))

    def data_sum(self, t):
        """A batch statistic summed over the data shards (no gradient)."""
        from repro_torch.runtime.collectives import all_reduce_sum

        g = self.group("data") if self.batch_sharded else None
        return all_reduce_sum(t.detach(), g) if g is not None else t.detach()


_ACTIVE: Optional[MeshContext] = None
_ONE_DEVICE = MeshContext()


def active() -> Optional[MeshContext]:
    """The LM mesh context in force (None: one device)."""
    return _ACTIVE


def context() -> MeshContext:
    """The LM mesh context in force, else the one-device context: the
    models run one code path for both."""
    return _ONE_DEVICE if _ACTIVE is None else _ACTIVE


class activation_sharding:
    """``with activation_sharding(mesh, rules):`` runs the models on this
    rank's blocks of ``mesh`` (``MeshContext``).  A process-wide setting,
    not a context variable: autograd recomputes checkpointed blocks on its
    own threads.  A mesh of one rank (or None) sets nothing."""

    def __init__(self, mesh, rules=None, *, batch_sharded: bool = True):
        self.ctx = None
        if mesh is not None and math.prod(mesh_shape(mesh).values()) > 1:
            self.ctx = MeshContext(mesh, rules, batch_sharded)

    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        if self.ctx is not None:
            _ACTIVE = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def constrain(x, logical_axes: Sequence[Optional[str]],
              require: Optional[str] = None):
    """This rank's block of ``x`` under the logical axes, the reference's
    sharding constraint: ``x`` is whole along every dim but ``batch``
    (which the step placed), and each dim whose axes map is cut to this
    rank's block (a differentiable view).

    - no mesh context: ``x`` unchanged;
    - nothing maps: ``x`` unchanged;
    - ``require=<name>``: only if that logical axis maps (the moe's
      expert-resident layout when ``n_experts`` is below the model degree).
    """
    ctx = active()
    if ctx is None:
        return x
    spec = operand_pspec(x.shape, logical_axes, ctx.mesh, ctx.rules)
    if require is not None and spec[list(logical_axes).index(require)] \
            is None:
        return x
    for dim, (name, axes) in enumerate(zip(logical_axes, spec)):
        if axes is None or name == "batch":
            continue
        idx, count = axes_index(ctx.mesh, axes)
        size = x.shape[dim] // count
        x = x.narrow(dim, idx * size, size)
    return x
