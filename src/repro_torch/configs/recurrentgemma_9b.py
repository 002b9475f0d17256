"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) ff12288 v256000.

RG-LRU recurrent blocks + local attention (window 2048), pattern
(rec, rec, attn) — 1 attention per 3 layers; 38 = 12 periods + 2 tail rec.
"""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "recurrentgemma-9b"


def cfgs():
    full = LMConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
        n_heads=16, n_kv_heads=1, d_head=256, d_ff=12288, vocab=256000,
        block_pattern=("rec", "rec", "attn"), window=2048, lru_width=4096,
        mlp="geglu", norm="rms", logit_softcap=30.0,
    )
    smoke = dataclasses.replace(
        full, name="recurrentgemma-9b-smoke", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=1, d_head=16, d_ff=128, vocab=256,
        window=16, lru_width=64, scan_chunk=8, attn_chunk=32,
    )
    return full, smoke
