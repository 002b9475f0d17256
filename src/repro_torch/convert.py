"""Carry parameters over from the JAX package.

The functions take JAX pytrees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the JAX side) and return the same
dicts of tensors on ``device``: ``params_from_jax`` a DONN's ``{"phase":
{"layer_i": tensor}}``, ``donn_state_from_jax`` a DONN train state
(``{"params", "mu", "nu", "step"}``, ``repro.runtime.donn_steps``),
``lm_params_from_jax`` an LM's ``{"embed", "final_norm", ...}`` tree with
its family's stacked groups (``blocks``; vlm's ``cross_blocks``; hybrid's
``rec_blocks``, ``attn_blocks``, ``tail_rec``; stacked axes kept),
``lm_train_state_from_jax`` an LM train state
(``repro.runtime.steps.init_train_state``; bf16 moments stay bf16).
They only walk dicts: nothing of JAX is imported (a bf16 array arrives
as numpy's ``bfloat16`` extension type and is read as its raw 2-byte
words).  The LM functions take ``mesh=`` and ``pspecs=`` (the tree's
placements, e.g. ``runtime.steps.compile_train_step``'s): they then
return this rank's blocks, each leaf cut on the host before it goes to
``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm


def _keep(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t``, or this rank's block of it under ``spec`` (a copy)."""
    if spec is None:
        return t
    from repro_torch.runtime.sharding import local_block

    return local_block(t, spec, mesh).clone(
        memory_format=torch.contiguous_format)


def _float_tree(tree, dev, specs=None, mesh=None):
    """Nested dicts of numpy arrays -> the same dicts of float32 tensors
    (this rank's blocks under ``specs`` on ``mesh``)."""
    if isinstance(tree, dict):
        return {k: _float_tree(v, dev, None if specs is None else specs[k],
                               mesh) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        raise TypeError(f"expected floating parameters, got {arr.dtype}")
    return _keep(torch.from_numpy(np.array(arr, np.float32)), specs,
                 mesh).to(dev)


def _moment_tree(tree, dev, specs=None, mesh=None):
    """Nested dicts of float arrays -> tensors of the same float type
    (f32, or bf16 from its raw words; this rank's blocks under ``specs``)."""
    if isinstance(tree, dict):
        return {k: _moment_tree(v, dev, None if specs is None else specs[k],
                                mesh) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # a copy: the caller's buffer stays
        t = torch.from_numpy(np.array(arr).view(np.int16)
                             ).view(torch.bfloat16)
    elif arr.dtype.kind != "f":
        raise TypeError(f"expected floating moments, got {arr.dtype}")
    else:
        t = torch.from_numpy(np.array(arr, np.float32))
    return _keep(t, specs, mesh).to(dev)


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


def lm_params_from_jax(tree, device=None, mesh=None, pspecs=None) -> dict:
    """A JAX LM parameter tree (``repro.models.lm.init``) -> the port's
    tree for ``repro_torch.models.lm``, on ``device`` (with ``mesh``: this
    rank's blocks under ``pspecs``)."""
    out = _float_tree(tree, resolve_device(device), pspecs, mesh)
    missing = {"embed", "final_norm"} - set(out)
    if missing:
        raise ValueError(f"expected an LM parameter tree; missing "
                         f"{sorted(missing)}")
    lm.stack_depths(out)  # one family's stacked groups, or ValueError
    return out


def lm_train_state_from_jax(state, device=None, mesh=None,
                            pspecs=None) -> dict:
    """A JAX LM train state -> the port's, on ``device``: params float32,
    AdamW moments in their own dtype (float32 or bf16), ``step`` an int32
    scalar (with ``mesh``: this rank's blocks under the state's
    ``pspecs``)."""
    missing = {"params", "mu", "nu", "step"} - set(state)
    if missing:
        raise ValueError(f"expected an LM train state; missing "
                         f"{sorted(missing)}")
    dev = resolve_device(device)
    sp = (lambda k: None) if pspecs is None else (lambda k: pspecs[k])
    out = {"params": lm_params_from_jax(state["params"], dev, mesh,
                                        sp("params")),
           "mu": _moment_tree(state["mu"], dev, sp("mu"), mesh),
           "nu": _moment_tree(state["nu"], dev, sp("nu"), mesh)}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=dev)
    return out
