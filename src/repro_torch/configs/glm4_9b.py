"""glm4-9b [dense]: 40L d4096 32H (GQA kv=2) ff13696 v151552 — RoPE(partial 0.5), GQA."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "glm4-9b"


def cfgs():
    full = LMConfig(
        name="glm4-9b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552,
        partial_rotary=0.5, mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="glm4-9b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, attn_chunk=32,
    )
    return full, smoke
