"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) ff14336 v128256.

Cross-attention image layers: 1 per 5 layers (8 cross + 32 self).  The
vision frontend is a stub, as in the reference: the model takes
precomputed patch embeddings (B, vision_seq, d_model).
"""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "llama-3.2-vision-11b"


def cfgs():
    full = LMConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
        cross_attn_period=5, vision_seq=1600, mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="llama-3.2-vision-11b-smoke", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        cross_attn_period=2, vision_seq=8, attn_chunk=32,
    )
    return full, smoke
