"""granite-8b [dense]: 36L d4096 32H (GQA kv=8) ff14336 v49152 — llama-arch, code."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "granite-8b"


def cfgs():
    full = LMConfig(
        name="granite-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152,
        mlp="swiglu", norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, attn_chunk=32,
    )
    return full, smoke
