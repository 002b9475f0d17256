"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) expert_ff 14336, 8e top-2, SWA 4096."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "mixtral-8x7b"


def cfgs():
    full = LMConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, expert_d_ff=14336, window=4096,
        mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, expert_d_ff=128, n_experts=4, vocab=256,
        window=16, attn_chunk=32,
    )
    return full, smoke
