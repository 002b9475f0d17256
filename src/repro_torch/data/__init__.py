"""Data of the port: synthetic digits and the batch pipeline (numpy/torch)."""
from repro_torch.data.synthetic import (
    batch_iterator,
    synth_digits,
    synth_rgb_scenes,
    synth_seg,
)

__all__ = ["batch_iterator", "synth_digits", "synth_rgb_scenes", "synth_seg"]
