"""The paper's own DONN architectures as registered configs.

The same six ``(full, smoke)`` pairs as ``repro.configs.donn``, in a plain
dict (the LM registry, ``repro_torch.models.config``, stays the LM
architectures'), each also returned by the reference's named function
(``donn3`` ... ``donn_xl``, the same objects):

- donn-mnist-3l : the physically-prototyped 3-layer system (paper §5.1):
                  200x200, 36um pixels, 532nm, z=0.28m (11 in).
- donn-mnist-5l : the DSE-explored 5-layer system (paper §4/§5.2), z=0.30m.
- donn-chip     : the on-chip integration case study (paper §5.5):
                  3.45um CMOS pixels, z=532um, 200x200.
- donn-rgb      : the multi-channel RGB classifier (paper Fig. 12).
- donn-seg      : the segmentation DONN with optical skip + LN (Fig. 13).
- donn-xl-500   : the large-scale emulation workload (Fig. 10): 500^2, 30 layers.

Beside them, ``HYBRID_SLM_PRINTED`` is the repo's one heterogeneous
stack: ``examples/advanced_donns.py``'s "hybrid-slm-printed" (three
64-px, 36 um, 256-level SLM layers 0.10 m apart feeding two 48-px, 48 um,
4-level printed layers 0.05 m apart, 0.06 m to the detector), spelled as
the ``DONNConfig`` that the DSL (``repro_torch.core.dsl``, as the
reference's) assembles for the example's ``dsl.models.sequential`` stack.
Its plan is two fused segments and one resample stitch.
"""
from repro_torch.core.config import DONNConfig, LayerSpec

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


def donn3() -> tuple:
    return CONFIGS["donn-mnist-3l"]


def donn5() -> tuple:
    return CONFIGS["donn-mnist-5l"]


def donn_chip() -> tuple:
    return CONFIGS["donn-chip"]


def donn_rgb() -> tuple:
    return CONFIGS["donn-rgb"]


def donn_seg() -> tuple:
    return CONFIGS["donn-seg"]


def donn_xl() -> tuple:
    return CONFIGS["donn-xl-500"]


def get_config(name: str, smoke: bool = False) -> DONNConfig:
    """The registered config ``name`` (its reduced smoke twin if asked)."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    full, small = CONFIGS[name]
    return small if smoke else full

_SLM = LayerSpec(distance=0.10, approximation="rs", codesign="qat",
                 device_levels=256, response_gamma=1.0, size=64,
                 pixel_size=36e-6)
_PRINTED = LayerSpec(distance=0.05, approximation="rs", codesign="qat",
                     device_levels=4, response_gamma=1.0, size=48,
                     pixel_size=48e-6)
HYBRID_SLM_PRINTED = DONNConfig(
    name="hybrid-slm-printed", n=64, pixel_size=36e-6, wavelength=532e-9,
    depth=5, distance=0.06, num_classes=10, det_size=8, codesign="qat",
    device_levels=256, response_gamma=1.0, layer_norm=False,
    layers=(_SLM,) * 3 + (_PRINTED,) * 2,
)
