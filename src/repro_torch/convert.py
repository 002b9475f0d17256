"""Carry parameters over from the JAX package.

``params_from_jax`` takes the JAX model's parameter pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns the port's ``{"phase": {"layer_i": tensor}}`` on
``device``.  It only walks dicts: nothing of JAX is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree, device=None) -> dict:
    """Nested dicts of numpy arrays -> the same dicts of float32 tensors."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"expected floating parameters, got {arr.dtype}")
        return torch.from_numpy(np.array(arr, np.float32)).to(dev)

    out = walk(tree)
    if not isinstance(out, dict) or "phase" not in out:
        raise ValueError("expected a DONN parameter tree {'phase': {...}}")
    return out
