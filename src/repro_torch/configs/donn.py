"""The paper's own DONN architectures as registered configs.

The same six ``(full, smoke)`` pairs as ``repro.configs.donn``, in a plain
dict instead of the JAX package's registry (which lives in
``repro.models``):

- donn-mnist-3l : the physically-prototyped 3-layer system (paper §5.1):
                  200x200, 36um pixels, 532nm, z=0.28m (11 in).
- donn-mnist-5l : the DSE-explored 5-layer system (paper §4/§5.2), z=0.30m.
- donn-chip     : the on-chip integration case study (paper §5.5):
                  3.45um CMOS pixels, z=532um, 200x200.
- donn-rgb      : the multi-channel RGB classifier (paper Fig. 12).
- donn-seg      : the segmentation DONN with optical skip + LN (Fig. 13).
- donn-xl-500   : the large-scale emulation workload (Fig. 10): 500^2, 30 layers.

The serving slice builds the classify configs; ``donn-rgb`` and
``donn-seg`` register here and build with the RGB/segmentation slice.
"""
from repro_torch.core.config import DONNConfig

CONFIGS = {
    "donn-mnist-3l": (
        DONNConfig(
            name="donn-mnist-3l", n=200, pixel_size=36e-6, wavelength=532e-9,
            distance=0.28, depth=3, num_classes=10, det_size=20,
        ),
        DONNConfig(
            name="donn-mnist-3l-smoke", n=64, depth=3, distance=0.05,
            det_size=8,
        ),
    ),
    "donn-mnist-5l": (
        DONNConfig(
            name="donn-mnist-5l", n=200, pixel_size=36e-6, wavelength=532e-9,
            distance=0.30, depth=5, num_classes=10, det_size=20, gamma=1.12,
            codesign="qat", device_levels=256,
        ),
        DONNConfig(
            name="donn-mnist-5l-smoke", n=64, depth=5, distance=0.05,
            det_size=8, gamma=1.12, codesign="qat",
        ),
    ),
    "donn-chip": (
        DONNConfig(
            name="donn-chip", n=200, pixel_size=3.45e-6, wavelength=532e-9,
            distance=532e-6, depth=5, num_classes=10, det_size=20,
            codesign="qat", device_levels=256,
        ),
        DONNConfig(
            name="donn-chip-smoke", n=64, pixel_size=3.45e-6,
            distance=532e-6, depth=3, det_size=8, codesign="qat",
        ),
    ),
    "donn-rgb": (
        DONNConfig(
            name="donn-rgb", n=200, pixel_size=36e-6, wavelength=532e-9,
            distance=0.30, depth=5, num_classes=6, det_size=20, channels=3,
            gamma=1.12,
        ),
        DONNConfig(
            name="donn-rgb-smoke", n=64, depth=2, distance=0.05, det_size=8,
            num_classes=6, channels=3,
        ),
    ),
    "donn-seg": (
        DONNConfig(
            name="donn-seg", n=350, pixel_size=36e-6, wavelength=532e-9,
            distance=0.30, depth=5, segmentation=True, skip_from=0,
            layer_norm=True, gamma=1.12,
        ),
        DONNConfig(
            name="donn-seg-smoke", n=64, depth=3, distance=0.05,
            segmentation=True, skip_from=0, layer_norm=True,
        ),
    ),
    "donn-xl-500": (
        DONNConfig(
            name="donn-xl-500", n=500, pixel_size=36e-6, wavelength=532e-9,
            distance=0.30, depth=30, num_classes=10, det_size=40, gamma=1.05,
        ),
        DONNConfig(
            name="donn-xl-500-smoke", n=96, depth=10, distance=0.05,
            det_size=8,
        ),
    ),
}


def get_config(name: str, smoke: bool = False) -> DONNConfig:
    """The registered config ``name`` (its reduced smoke twin if asked)."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    full, small = CONFIGS[name]
    return small if smoke else full
