"""LM families of the port: the six families of ``repro.models``.

``config`` (``LMConfig``, registry), ``layers`` (norms, MLPs, embeddings,
RoPE), ``attention`` (self, cached decode, vlm cross-attention), ``ssm``
(mamba-1), ``moe`` (capacity-based expert dispatch), ``rglru`` (the
Griffin recurrent block) and ``lm`` (specs, forward, logits, loss, decode
cache and step).
"""
from repro_torch.models.config import (
    LM_SHAPES,
    LMConfig,
    ShapeCell,
    get_config,
    list_archs,
)
from repro_torch.models import lm

__all__ = ["LMConfig", "LM_SHAPES", "ShapeCell", "get_config", "list_archs",
           "lm"]
