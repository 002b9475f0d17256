"""Logical-axis sharding rules for the DONN mesh (``repro.runtime.sharding``).

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
counterpart of placing an array with a ``NamedSharding``.
"""
from __future__ import annotations

import math
import os
from typing import Any, Mapping, Optional, Sequence

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
    ``model``.  Without a process group one is initialised from the
    environment (``env://``: ``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``),
    or, for a 1x1 mesh with no such environment, as a group of this one
    process.  ``backend`` defaults to NCCL for a CUDA ``device`` and gloo
    for the CPU (gloo ranks may share one card).  The mesh spans the whole
    world: every rank runs the same program on its block (SPMD).
    """
    need = int(data) * int(model)
    have = world_size()
    if need > have:
        raise ValueError(
            f"make_mesh_2d needs {need} ranks ({data} data x {model} model), "
            f"have {have}"
        )
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
            f"make_mesh_2d: a {data}x{model} mesh must span every rank of "
            f"the process group ({dist.get_world_size()})"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (int(data), int(model)),
                            mesh_dim_names=("data", "model"))


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
    sharded dim cut to the rank's slice (a view)."""
    t = torch.as_tensor(t)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx, count = axes_index(mesh, axes)
        if t.shape[dim] % count:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not divide over "
                f"{axes!r} ({count} ranks)"
            )
        size = t.shape[dim] // count
        t = t.narrow(dim, idx * size, size)
    return t


def axes_group(mesh, axes):
    """The process group of the ranks that differ only along ``axes``: the
    named axis's group when one of them holds more than one rank, the
    whole world when they cover every axis of the mesh (it spans the
    world, a 1x1 mesh too), else None (this rank alone)."""
    sizes = mesh_shape(mesh)
    flat = _flat_axes(axes)
    wide = [a for a in flat if sizes.get(a, 1) > 1]
    if len(wide) == 1:
        return mesh.get_group(wide[0])
    if set(flat) >= set(sizes):
        return dist.group.WORLD
    if not wide:
        return None
    raise NotImplementedError(f"no process group for axes {axes!r}")


def group_count(mesh, axes) -> int:
    """Ranks along ``axes`` (1 when none of them is in the mesh)."""
    sizes = mesh_shape(mesh)
    return math.prod(sizes.get(a, 1) for a in _flat_axes(axes))
