"""Carry parameters over from the JAX package.

The functions take JAX pytrees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the JAX side) and return the same
dicts of tensors on ``device``: ``params_from_jax`` a DONN's ``{"phase":
{"layer_i": tensor}}``, ``donn_state_from_jax`` a DONN train state
(``{"params", "mu", "nu", "step"}``, ``repro.runtime.donn_steps``),
``lm_params_from_jax`` an LM's ``{"embed", "final_norm", "blocks"}`` tree
(stacked "layers" axis kept).  They only walk dicts: nothing of JAX is
imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _float_tree(tree, dev):
    """Nested dicts of numpy arrays -> the same dicts of float32 tensors."""
    if isinstance(tree, dict):
        return {k: _float_tree(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        raise TypeError(f"expected floating parameters, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, np.float32)).to(dev)


def params_from_jax(tree, device=None) -> dict:
    """A JAX DONN parameter tree -> the port's, on ``device``."""
    out = _float_tree(tree, resolve_device(device))
    if not isinstance(out, dict) or "phase" not in out:
        raise ValueError("expected a DONN parameter tree {'phase': {...}}")
    return out


def donn_state_from_jax(state, device=None) -> dict:
    """A JAX DONN train state -> the port's, on ``device``: params and AdamW
    moments float32, ``step`` an int32 scalar."""
    missing = {"params", "mu", "nu", "step"} - set(state)
    if missing:
        raise ValueError(f"expected a DONN train state; missing "
                         f"{sorted(missing)}")
    dev = resolve_device(device)
    out = {k: params_from_jax(state[k], dev) for k in ("params", "mu", "nu")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def lm_params_from_jax(tree, device=None) -> dict:
    """A JAX LM parameter tree (``repro.models.lm.init``) -> the port's
    tree for ``repro_torch.models.lm``, on ``device``."""
    out = _float_tree(tree, resolve_device(device))
    missing = {"embed", "final_norm", "blocks"} - set(out)
    if missing:
        raise ValueError(f"expected an LM parameter tree; missing "
                         f"{sorted(missing)}")
    return out
