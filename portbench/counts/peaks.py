"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit).  The DONN path computes in float32 outside the
tensor cores, so its compute peak is the plain float32 rate."""

F32_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the compute
    and the memory bound."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
