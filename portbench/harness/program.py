"""What the harness hands the port: its configuration and weights.

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
