"""Operations and bytes of each hand-written kernel launch and each FFT.

``ENTRY_POINTS`` maps the port's raw kernel entry points
(``repro_torch.kernels.ops``) to the device kernels they launch, as the
profiler names them, and to the cost of one launch at its argument
shapes.  Bytes count each input read once and each output written once;
fields are complex64 (8 bytes), planes and masks float32 (4 bytes).

It holds the DONN kernels below (``KERNELS``) and the ``ENTRY_POINTS``
of every cost file ``counts/kernels_<name>.py`` beside this one, so a
new family's kernels are counted by a file of their own; an entry point
counted twice raises.  A cost file may import this module's constants.
"""
from __future__ import annotations

import importlib.util
import math
import pathlib

C64 = 8
F32 = 4


def _plane_pair(shapes) -> tuple:
    """K1 and K2: x (fields, H, W) complex64, theta and amp (planes, H,
    W) float32; out like x.  Per field element one complex multiply by
    the plane's amp * exp(j theta) (6), per plane element 3."""
    (fields, h, w), (planes, _, _) = shapes[0], shapes[1]
    hw = h * w
    flops = 6.0 * fields * hw + 3.0 * planes * hw
    nbytes = 2 * C64 * fields * hw + 2 * F32 * planes * hw
    return flops, nbytes


def _readout(shapes) -> tuple:
    """K3: u (rows, H, W) complex64, masks (classes, H, W) float32 ->
    (rows, classes) float32: |u|^2 (3) and a multiply-add a class (2)
    per element."""
    (rows, h, w), (classes, _, _) = shapes[0], shapes[1]
    hw = h * w
    flops = rows * hw * (3.0 + 2.0 * classes)
    nbytes = C64 * rows * hw + F32 * classes * hw + F32 * rows * classes
    return flops, nbytes


# entry point -> (device kernel name fragments, cost of one launch, the
# name the port's launch counter (``ops.launch_counts``) gives it)
KERNELS = {
    "conj_phase_scale": (("conj_phase_scale_kernel",), _plane_pair,
                         "conj_phase_scale"),
    "phase_tf_apply_planes": (("phase_tf_apply_kernel",), _plane_pair,
                              "phase_tf_apply"),
    "intensity_readout_rows": (("readout_partial_kernel",
                                "readout_finish_kernel"), _readout,
                               "intensity_readout"),
}


# torch.fft functions -> the transform they ask cuFFT for; cuFFT's device
# kernels carry "fft" in their names
FFT_FUNCTIONS = {"fft": "c2c", "ifft": "c2c", "fft2": "c2c", "ifft2": "c2c",
                 "fftn": "c2c", "ifftn": "c2c", "rfft2": "r2c",
                 "irfft2": "c2r"}
FFT_KERNELS = ("fft",)


def fft_cost(function: str, shape, dims) -> tuple:
    """One ``torch.fft`` call on an input of ``shape`` over ``dims``: a
    complex transform of N points counts 5 N log2 N, a real one half
    that; the input is read once and the output written once (complex64
    8 bytes an element, float32 4)."""
    kind = FFT_FUNCTIONS[function]
    shape = list(shape)
    dims = [d % len(shape) for d in dims]
    numel = math.prod(shape)
    if kind == "c2r":  # the last transformed dim holds n // 2 + 1
        out = list(shape)
        out[dims[-1]] = 2 * (shape[dims[-1]] - 1)
        points = math.prod(out[d] for d in dims)
        nbytes = C64 * numel + F32 * math.prod(out)
    elif kind == "r2c":
        points = math.prod(shape[d] for d in dims)
        out = list(shape)
        out[dims[-1]] = shape[dims[-1]] // 2 + 1
        nbytes = F32 * numel + C64 * math.prod(out)
    else:
        points = math.prod(shape[d] for d in dims)
        nbytes = 2 * C64 * numel
    batch = math.prod(shape) // math.prod(shape[d] for d in dims)
    per = 5.0 * points * math.log2(points) if points > 1 else 0.0
    return (per if kind == "c2c" else per / 2.0) * batch, nbytes


HERE = pathlib.Path(__file__).resolve().parent


def cost_files(directory: pathlib.Path = HERE) -> list:
    """The modules ``kernels_<name>.py`` in ``directory``, by name."""
    out = []
    for path in sorted(directory.glob("kernels_*.py")):
        spec = importlib.util.spec_from_file_location(
            f"portbench.counts.{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out.append(module)
    return out


def entry_points(modules) -> dict:
    """``KERNELS`` with each module's ``ENTRY_POINTS``; an entry point
    that two of them count raises ``ValueError``."""
    out = dict(KERNELS)
    for module in modules:
        for name, entry in module.ENTRY_POINTS.items():
            if name in out:
                raise ValueError(f"{module.__name__} counts entry point "
                                 f"{name!r}, which is counted already")
            out[name] = entry
    return out


ENTRY_POINTS = entry_points(cost_files())
