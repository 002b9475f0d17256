"""Registered configurations of the port (plain dict registries).

``CONFIGS``/``get_config``: the DONN architectures (``configs.donn``).
``LM_CONFIGS``: the LM architectures of the families this port serves
(dense and ssm), ``{name: (full, smoke)}``, one module each as in the JAX
package; ``repro_torch.models.config.get_config`` reads it.
``LM_PENDING`` names the reference's other LM architectures, whose
families come with later slices.
"""
from repro_torch.configs import (
    falcon_mamba_7b,
    glm4_9b,
    granite_8b,
    qwen1_5_4b,
    qwen2_5_14b,
)
from repro_torch.configs.donn import CONFIGS, get_config

LM_CONFIGS = {m.NAME: m.cfgs() for m in (
    glm4_9b, granite_8b, qwen1_5_4b, qwen2_5_14b, falcon_mamba_7b)}
LM_PENDING = {
    "mixtral-8x7b": "moe",
    "arctic-480b": "moe",
    "llama-3.2-vision-11b": "vlm",
    "musicgen-medium": "audio",
    "recurrentgemma-9b": "hybrid",
}

__all__ = ["CONFIGS", "LM_CONFIGS", "LM_PENDING", "get_config"]
