"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) 128e top-2 expert_ff 4864 + dense residual."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "arctic-480b"


def cfgs():
    full = LMConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
        n_experts=128, top_k=2, expert_d_ff=4864, dense_residual_ff=4864,
        mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, expert_d_ff=96, dense_residual_ff=96,
        n_experts=8, vocab=256, attn_chunk=32,
    )
    return full, smoke
