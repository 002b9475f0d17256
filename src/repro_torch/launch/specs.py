"""Input stand-ins for every (arch x shape) dry-run cell (port of
``repro.launch.specs``).

Nothing here allocates: each input is a meta tensor of the cell's global
shape and dtype (the reference's ``ShapeDtypeStruct``).  Frontend stubs as
in the reference: vlm cells get precomputed patch embeddings, audio cells
EnCodec token ids (plain int tokens: the backbone is token-in).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.donn import CONFIGS as DONN_CONFIGS
from repro_torch.configs.donn import get_config as donn_config
from repro_torch.core.config import DONNConfig
from repro_torch.models import lm
from repro_torch.models.config import LM_SHAPES, LMConfig, ShapeCell
from repro_torch.models.config import get_config as lm_config
from repro_torch.runtime import sharding as shd

# DONN cells use their own shape list (training emulation workloads).
DONN_SHAPES = (
    ShapeCell("train_b1024", 0, 1024, "train"),
    ShapeCell("train_b256", 0, 256, "train"),
)


def get_config(arch: str, smoke: bool = False):
    """The registered config of an LM or DONN architecture id."""
    if arch in DONN_CONFIGS:
        return donn_config(arch, smoke=smoke)
    return lm_config(arch, smoke=smoke)


def shapes_for(cfg) -> tuple:
    if isinstance(cfg, DONNConfig):
        return (DONN_SHAPES[1],) if cfg.n >= 500 else (DONN_SHAPES[0],)
    return LM_SHAPES


def cell_status(cfg, cell: ShapeCell) -> Optional[str]:
    """None if the cell runs; otherwise a documented skip reason."""
    if isinstance(cfg, DONNConfig):
        return None
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "SKIP(full-attention): 524k dense-KV decode is the quadratic-"
            "attention regime this cell excludes (DESIGN.md §5)"
        )
    return None


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_train_specs(cfg: LMConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    specs = {
        "tokens": _abstract((B, S), torch.int32),
        "labels": _abstract((B, S), torch.int32),
    }
    if cfg.family == "vlm":
        specs["vision"] = _abstract((B, cfg.vision_seq, cfg.d_model),
                                    cfg.dtype)
    return specs


def lm_prefill_specs(cfg: LMConfig, cell: ShapeCell) -> dict:
    specs = {"tokens": _abstract((cell.global_batch, cell.seq_len),
                                 torch.int32)}
    if cfg.family == "vlm":
        specs["vision"] = _abstract(
            (cell.global_batch, cfg.vision_seq, cfg.d_model), cfg.dtype)
    return specs


def lm_decode_specs(cfg: LMConfig, cell: ShapeCell) -> dict:
    B = cell.global_batch
    return {
        "tokens": _abstract((B, 1), torch.int32),
        "pos": _abstract((), torch.int32),
        "cache": shd.abstract_like(lm.cache_specs(cfg, B, cell.seq_len)),
    }


def donn_train_specs(cfg: DONNConfig, cell: ShapeCell) -> dict:
    B = cell.global_batch
    if cfg.segmentation:
        return {
            "images": _abstract((B, cfg.n, cfg.n), torch.float32),
            "masks": _abstract((B, cfg.n, cfg.n), torch.float32),
        }
    if cfg.channels > 1:
        return {
            "images": _abstract((B, cfg.channels, cfg.n, cfg.n),
                                torch.float32),
            "labels": _abstract((B,), torch.int32),
        }
    return {
        "images": _abstract((B, cfg.n, cfg.n), torch.float32),
        "labels": _abstract((B,), torch.int32),
    }


def input_specs(arch: str, shape_name: str, smoke: bool = False):
    """(arch, shape) -> (cfg, cell, kind, specs dict)."""
    cfg = get_config(arch, smoke=smoke)
    cells = {c.name: c for c in shapes_for(cfg)}
    if shape_name not in cells:
        raise KeyError(f"{arch}: unknown shape {shape_name!r} (has "
                       f"{list(cells)})")
    cell = cells[shape_name]
    if isinstance(cfg, DONNConfig):
        return cfg, cell, "train", donn_train_specs(cfg, cell)
    if cell.kind == "train":
        return cfg, cell, "train", lm_train_specs(cfg, cell)
    if cell.kind == "prefill":
        return cfg, cell, "prefill", lm_prefill_specs(cfg, cell)
    return cfg, cell, "decode", lm_decode_specs(cfg, cell)
