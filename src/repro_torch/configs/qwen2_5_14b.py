"""qwen2.5-14b [dense]: 48L d5120 40H (GQA kv=8) ff13824 v152064 — GQA, QKV bias."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "qwen2.5-14b"


def cfgs():
    full = LMConfig(
        name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
        qkv_bias=True, mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="qwen2.5-14b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, attn_chunk=32,
    )
    return full, smoke
