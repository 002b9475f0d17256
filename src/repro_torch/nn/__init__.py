"""Functional parameter system of the port (the LM part of ``repro.nn``)."""
from repro_torch.nn.module import (
    ParamSpec,
    abstract_params,
    cast_tree,
    init_params,
    is_spec,
    logical_to_pspec,
    param_bytes,
    param_count,
    specs_to_pspecs,
    specs_to_shardings,
)

__all__ = ["ParamSpec", "abstract_params", "cast_tree", "init_params",
           "is_spec", "logical_to_pspec", "param_bytes", "param_count",
           "specs_to_pspecs", "specs_to_shardings"]
