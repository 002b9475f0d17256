"""What the harness hands the port: its configuration and weights.

A configuration file's fields become the port's ``DONNConfig``
(``donn_config``) or, for a language model, its ``LMConfig``
(``lm_config``).

The weights are the harness's, made on the device from the seed in one
call, and never the port's ``init``: the reference can make the same
ones again without taking anything the port computed.
"""
from __future__ import annotations

import math

import torch

from portbench.harness import seeds


def donn_config(fields: dict):
    """The port's ``DONNConfig`` from a configuration file's fields."""
    from repro_torch.core.config import DONNConfig

    return DONNConfig(**fields)


def lm_fields(fields: dict) -> dict:
    """A configuration file's fields as the port's ``LMConfig`` takes
    them: ``dtype``'s name (``"bfloat16"``) as the torch dtype, a list
    as a tuple."""
    out = {}
    for k, v in fields.items():
        if k == "dtype":
            v = getattr(torch, v, None)
            if not isinstance(v, torch.dtype):
                raise ValueError(f"dtype {fields[k]!r} names no torch dtype")
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return out


def lm_config(fields: dict):
    """The port's ``LMConfig`` from a configuration file's fields.  Keys
    that are no field of it, such as a catalog model's own names for its
    sizes kept beside the fields, are left out."""
    import dataclasses

    from repro_torch.models.config import LMConfig

    names = {f.name for f in dataclasses.fields(LMConfig)}
    return LMConfig(**{k: v for k, v in lm_fields(fields).items()
                       if k in names})


def phases(seed: int, tag: int, shape, device) -> torch.Tensor:
    """Phases uniform on [0, 2 pi), float32, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, seeds.WEIGHTS, tag))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=device)
    return u * (2.0 * math.pi)


def as_params(stack: torch.Tensor) -> dict:
    """A (depth, n, n) stack as the port's parameter tree."""
    return {"phase": {f"layer_{i}": stack[i] for i in range(stack.shape[0])}}


def leaf_stack(params: dict) -> torch.Tensor:
    """The port's parameter tree back as a (depth, n, n) stack."""
    layers = params["phase"]
    return torch.stack([layers[f"layer_{i}"] for i in range(len(layers))])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def gap(got, want, floor) -> float:
    """|got - want| as a share of max(|want|, floor)."""
    return abs(float(got) - float(want)) / max(abs(float(want)), float(floor))


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of any reading in a row of ``got`` from ``want``,
    as a share of that row's largest reference reading."""
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())
