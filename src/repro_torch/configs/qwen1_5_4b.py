"""qwen1.5-4b [dense]: 40L d2560 20H (kv=20, MHA) ff6912 v151936 — QKV bias."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "qwen1.5-4b"


def cfgs():
    full = LMConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936,
        qkv_bias=True, mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="qwen1.5-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, attn_chunk=32,
    )
    return full, smoke
