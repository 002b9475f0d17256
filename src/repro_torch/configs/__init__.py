"""Registered configurations of the port (plain dict registries).

``CONFIGS``/``get_config``: the DONN architectures (``configs.donn``).
``LM_CONFIGS``: the reference's ten LM architectures over its six
families, ``{name: (full, smoke)}``, one module each as in the JAX
package; ``repro_torch.models.config.get_config`` reads it.
"""
from repro_torch.configs import (
    arctic_480b,
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

__all__ = ["CONFIGS", "LM_CONFIGS", "get_config"]
