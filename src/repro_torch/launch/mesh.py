"""Mesh construction and the card's rates (port of ``repro.launch.mesh``).

``make_mesh`` builds a ``DeviceMesh`` over the ranks of the process group:
the 2-D ``("data", "model")`` mesh that ``launch/train.py`` and
``launch/serve.py`` build for ``--mesh DxM`` (batch and FSDP over
``data``; heads, ``mlp``, experts, vocabulary and the sequence between
layers over ``model``), or the 3-D ``("pod", "data", "model")`` one of
the multi-pod dry-run.  ``make_production_mesh`` is the reference's
production layout, one pod of 256 ranks as 16 x 16 ``(data, model)`` or
two pods as ``(2, 16, 16)``, so the two packages' dry-run records
compare cell by cell; the dry-run (``launch/dryrun.py``) builds it on a
fake process group of 256 or 512 ranks.

The constants are the roofline rates of one NVIDIA H100 80GB HBM3 SXM
(its datasheet, at its 700 W limit), the counterpart of the reference's
TPU v5e figures.  The collective term keeps the reference's single rate
(``collective_bytes / LINK_BW``): a 256-rank H100 mesh spans 32 nodes of
8 cards, so the rings of a wide group also cross the slower inter-node
network, which this one NVLink rate does not model.
"""
from __future__ import annotations

from repro_torch.runtime.sharding import make_device_mesh

# NVIDIA H100 80GB HBM3 SXM datasheet, at 700 W (per card):
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
LINK_BW = 450e9  # B/s, NVLink 4, one direction
# bytes of device memory: torch.cuda.get_device_properties(0).total_memory
# on the card (chip_smoke.py's dryrun phase asserts it)
HBM_PER_DEVICE = 85_017_493_504

AXES = ("data", "model")
AXES_3D = ("pod", "data", "model")


def make_mesh(shape, axes=AXES, *, device=None):
    """A ``DeviceMesh`` of ``shape`` over ``axes``: the 2-D
    ``("data", "model")`` layout or the 3-D ``("pod", "data", "model")``
    one (the reference's rules place ``batch`` over ``("pod", "data")``
    and FSDP over ``("data", "pod")``)."""
    axes = tuple(axes)
    if axes not in (AXES, AXES_3D) or len(shape) != len(axes):
        raise NotImplementedError(
            f"make_mesh{tuple(shape)} over {axes}: the port builds the "
            f"{AXES} and {AXES_3D} meshes")
    return make_device_mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``;
    the process group must hold its 256 or 512 ranks."""
    if multi_pod:
        return make_device_mesh((2, 16, 16), AXES_3D, device=device)
    return make_device_mesh((16, 16), AXES, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``data`` x ``model`` mesh over the ranks there are (initialising a
    one-process group for 1x1 when none exists)."""
    return make_device_mesh((data, model), AXES, device=device)
