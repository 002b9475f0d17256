"""falcon-mamba-7b [ssm]: 64L d4096 attn-free mamba1, ssm_state=16, v65024."""
import dataclasses

from repro_torch.models.config import LMConfig

NAME = "falcon-mamba-7b"


def cfgs():
    full = LMConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024,
        ssm_state=16, d_inner=8192, d_conv=4, dt_rank=256, norm="rms",
    )
    smoke = dataclasses.replace(
        full, name="falcon-mamba-7b-smoke", n_layers=2, d_model=64,
        vocab=256, ssm_state=4, d_inner=128, dt_rank=8, scan_chunk=8,
    )
    return full, smoke
