"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit).  The DONN path computes in float32 outside the
tensor cores, so its compute peak is the plain float32 rate; a path that
computes in bfloat16 on the tensor cores is held to ``BF16_FLOPS``."""

F32_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores
BF16_FLOPS = 989.4e12    # bfloat16 FLOP/s on the tensor cores, dense
HBM_BYTES = 3.35e12      # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the compute
    and the memory bound."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
