"""Functional parameter system of the port (the LM part of ``repro.nn``)."""
from repro_torch.nn.module import (
    ParamSpec,
    cast_tree,
    init_params,
    is_spec,
    param_count,
)

__all__ = ["ParamSpec", "cast_tree", "init_params", "is_spec", "param_count"]
