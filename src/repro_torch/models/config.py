"""LM architecture configuration and registry (port of ``repro.models.config``).

``LMConfig`` keeps the reference's fields, names and defaults; ``dtype`` is
a torch dtype (default ``torch.bfloat16``), the type every matmul runs in
while parameters stay float32.  The registry is a plain dict filled from
``repro_torch.configs`` (one module per architecture, as in the JAX
package) and holds all ten of the reference's architectures;
``register`` adds a ``(full, smoke)`` factory beside them, called lazily
as the reference's registry calls its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

DENSE, MOE, VLM, AUDIO, SSM, HYBRID = (
    "dense", "moe", "vlm", "audio", "ssm", "hybrid",
)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Architecture description covering all six families of the reference."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu | geglu
    norm: str = "rms"  # rms | ln
    rope_theta: float = 1e4
    partial_rotary: float = 1.0  # glm4: 0.5
    tie_embeddings: bool = False
    # --- attention window (0 = full causal) ---
    window: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 0
    # --- VLM (cross-attention) ---
    cross_attn_period: int = 0
    vision_seq: int = 0
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    d_inner: int = 0
    d_conv: int = 4
    dt_rank: int = 0
    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple = ()
    lru_width: int = 0
    logit_softcap: float = 0.0
    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # --- runtime hints ---
    attn_chunk: int = 1024  # KV-chunk for online-softmax attention
    attn_p_bf16: bool = False  # softmax probs in bf16 for the PV product
    scan_chunk: int = 128  # recurrence chunk for ssm/rglru
    remat: bool = True  # read by the training slice; serving ignores it

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def sub_quadratic(self) -> bool:
        return self.family in (SSM, HYBRID) or self.window > 0


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the reference's dry-run matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


_REGISTRY: dict[str, Callable[[], tuple]] = {}


def register(name: str):
    """Decorator: register a factory returning ``(full, smoke)`` under
    ``name``, so ``get_config`` and ``list_archs`` see it."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, smoke: bool = False) -> LMConfig:
    """The registered FULL (or SMOKE) config of an architecture id."""
    from repro_torch.configs import LM_CONFIGS

    if name in LM_CONFIGS:
        full, smoke_cfg = LM_CONFIGS[name]
    elif name in _REGISTRY:
        full, smoke_cfg = _REGISTRY[name]()
    else:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return smoke_cfg if smoke else full


def list_archs() -> list[str]:
    """The architectures the port can build."""
    from repro_torch.configs import LM_CONFIGS

    return sorted(set(LM_CONFIGS) | set(_REGISTRY))
