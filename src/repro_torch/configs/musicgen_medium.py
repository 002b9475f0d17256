"""musicgen-medium [audio]: 48L d1536 24H (MHA) ff6144 v2048 — decoder over EnCodec tokens.

The EnCodec frontend is a stub, as in the reference: the model takes
precomputed frame token ids; the backbone is a LayerNorm + GELU
decoder-only transformer.
"""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "musicgen-medium"


def cfgs():
    full = LMConfig(
        name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
        mlp="gelu", norm="ln",
    )
    smoke = dataclasses.replace(
        full, name="musicgen-medium-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=64, attn_chunk=32,
    )
    return full, smoke
