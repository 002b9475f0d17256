"""Minimal functional parameter system (``repro.nn.module``).

Parameters are nested dicts of tensors.  Every model exposes
``param_specs(cfg) -> tree of ParamSpec`` (shape, dtype, logical axes,
initializer) and ``init_params`` materializes a spec tree from a
``torch.Generator``: leaves are drawn in sorted-key order (the order of
``jax.tree``), each directly on the generator's device.  The generator
gives other numbers than the reference's threefry keys, so parity tests
carry JAX parameters over with ``repro_torch.convert.lm_params_from_jax``.

The logical axes map onto the ``(data, model)`` mesh through the rules
of ``repro_torch.runtime.sharding``; ``logical_to_pspec`` and the spec
maps below are the reference's plain rules lookup (no divisibility
fallback), and ``init_params(..., mesh=)`` keeps each rank's block of
every leaf as it is drawn.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/init/logical-axes description of one parameter."""

    shape: tuple
    dtype: Any = torch.float32
    logical_axes: tuple = ()
    init: str = "fan_in"  # fan_in | normal | zeros | ones | uniform_phase
    #                      | embed | s4d_a_log | rglru_lambda
    scale: float = 1.0

    def __post_init__(self):
        if self.logical_axes and len(self.logical_axes) != len(self.shape):
            raise ValueError(
                f"logical_axes {self.logical_axes} rank != shape {self.shape}"
            )


def _normal(spec: ParamSpec, gen: torch.Generator, std: float):
    x = torch.randn(spec.shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(std).to(spec.dtype)


def _initialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "uniform_phase":  # phases in [0, 2pi): DONN layers
        x = torch.rand(spec.shape, generator=gen, device=dev,
                       dtype=torch.float32)
        return (x * (2.0 * math.pi)).to(spec.dtype) * spec.scale
    if spec.init in ("normal", "embed"):
        return _normal(spec, gen, spec.scale)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return _normal(spec, gen, spec.scale / math.sqrt(max(fan_in, 1)))
    if spec.init == "s4d_a_log":  # mamba A_log: log(1..state) per channel row
        state = spec.shape[-1]
        row = torch.log(torch.arange(1, state + 1, dtype=torch.float32,
                                     device=dev))
        return row.expand(spec.shape).to(spec.dtype).contiguous()
    if spec.init == "rglru_lambda":  # a = sigmoid(L) uniform in [0.9, 0.999]
        a = torch.rand(spec.shape, generator=gen, device=dev,
                       dtype=torch.float32) * (0.999 - 0.9) + 0.9
        return torch.log(a / (1.0 - a)).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_params(specs, gen: torch.Generator, mesh=None, rules=None):
    """Materialize a ParamSpec tree into tensors on ``gen``'s device.

    With ``mesh``, each leaf is drawn whole in the same order and only this
    rank's block (``runtime.sharding.local_block`` under the leaf's
    resolved spec) is kept before the next is drawn: bit for bit the
    blocks of the whole tree, with one whole leaf alive at a time."""
    if mesh is None:
        return tree_unflatten(specs, [_initialize(s, gen)
                                      for s in tree_leaves(specs)])
    from repro_torch.runtime.sharding import local_block, spec_sharding

    out = []
    for s in tree_leaves(specs):
        whole = _initialize(s, gen)
        out.append(local_block(whole, spec_sharding(s, mesh, rules), mesh)
                   .clone(memory_format=torch.contiguous_format))
        del whole
    return tree_unflatten(specs, out)


def abstract_params(specs):
    """Meta tensors of a spec tree's shapes and dtypes (no memory)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     rules: Mapping[str, Any]) -> tuple:
    """Logical axis names -> mesh axes through ``rules`` (None replicates
    a dim), trailing Nones trimmed: the reference's ``PartitionSpec`` as a
    tuple."""
    out = [None if name is None else rules.get(name)
           for name in logical_axes]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _axes(s: ParamSpec) -> tuple:
    return s.logical_axes or (None,) * len(s.shape)


def specs_to_pspecs(specs, rules: Mapping[str, Any]):
    return tree_map(lambda s: logical_to_pspec(_axes(s), rules), specs)


def specs_to_shardings(specs, rules: Mapping[str, Any], mesh):
    """The placements of a spec tree on ``mesh``, each a spec tuple as
    ``runtime.sharding.tree_shardings`` gives them (the reference's
    ``NamedSharding(mesh, logical_to_pspec(...))``; ``mesh`` names where
    they apply and is not read)."""
    return specs_to_pspecs(specs, rules)


def param_bytes(tree) -> int:
    """Bytes of a tree of ParamSpecs or tensors."""
    return sum(math.prod(x.shape) * torch.empty((), dtype=x.dtype)
               .element_size() if is_spec(x) else x.numel() * x.element_size()
               for x in tree_leaves(tree))


def param_count(tree) -> int:
    return sum(math.prod(x.shape) if is_spec(x) else x.numel()
               for x in tree_leaves(tree))


def cast_tree(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
