"""LM family of the port: the dense and ssm serving path of ``repro.models``.

``config`` (``LMConfig``, registry), ``layers`` (norms, MLPs, embeddings,
RoPE), ``attention``, ``ssm`` (mamba-1) and ``lm`` (specs, forward,
logits, decode cache and step).  The moe, vlm, audio and hybrid families
raise ``NotImplementedError`` until their slice.
"""
from repro_torch.models.config import LMConfig, get_config, list_archs

__all__ = ["LMConfig", "get_config", "list_archs"]
