"""Optimizers and learning-rate schedules of the port (``repro.optim``)."""
from repro_torch.optim.adamw import (
    SGD, AdamW, AdamWState, clip_by_global_norm, global_norm,
)
from repro_torch.optim.compression import (
    compressed_psum_mean, compression_ratio, dequantize_int8, ef_quantize,
    quantize_int8, tree_compressed_psum_mean,
)
from repro_torch.optim.schedules import constant, step_decay, warmup_cosine

__all__ = [
    "AdamW", "AdamWState", "SGD", "clip_by_global_norm", "global_norm",
    "compressed_psum_mean", "compression_ratio", "dequantize_int8",
    "ef_quantize", "quantize_int8", "tree_compressed_psum_mean",
    "constant", "step_decay", "warmup_cosine",
]
