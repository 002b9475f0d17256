"""Registered configurations of the port (plain dict registries).

``CONFIGS``/``get_config``: the DONN architectures (``configs.donn``).
``LM_CONFIGS``: the reference's ten LM architectures over its six
families, ``{name: (full, smoke)}``, one module each as in the JAX
package; ``repro_torch.models.config.get_config`` reads it.
"""
from repro_torch.configs import (
    arctic_480b,
    donn,
    falcon_mamba_7b,
    glm4_9b,
    granite_8b,
    llama_3_2_vision_11b,
    mixtral_8x7b,
    musicgen_medium,
    qwen1_5_4b,
    qwen2_5_14b,
    recurrentgemma_9b,
)
from repro_torch.configs.donn import CONFIGS, get_config

LM_CONFIGS = {m.NAME: m.cfgs() for m in (
    glm4_9b, granite_8b, qwen1_5_4b, qwen2_5_14b, mixtral_8x7b, arctic_480b,
    llama_3_2_vision_11b, musicgen_medium, falcon_mamba_7b,
    recurrentgemma_9b)}

# the dry-run's sweep, in the reference's order (``repro.configs``)
LM_ARCHS = (
    "glm4-9b", "granite-8b", "qwen1.5-4b", "qwen2.5-14b", "mixtral-8x7b",
    "arctic-480b", "llama-3.2-vision-11b", "musicgen-medium",
    "falcon-mamba-7b", "recurrentgemma-9b",
)
DONN_ARCHS = (
    "donn-mnist-3l", "donn-mnist-5l", "donn-chip", "donn-rgb", "donn-seg",
    "donn-xl-500",
)

__all__ = ["CONFIGS", "DONN_ARCHS", "LM_ARCHS", "LM_CONFIGS", "donn",
           "get_config"]
