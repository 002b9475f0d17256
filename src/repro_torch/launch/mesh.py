"""Mesh construction for the launchers (port of ``repro.launch.mesh``).

Thin wrappers over ``repro_torch.runtime.sharding.make_mesh_2d``: a 2-D
``("data", "model")`` ``DeviceMesh`` over the ranks of the process group,
the mesh that ``launch/train.py`` and ``launch/serve.py`` build for
``--mesh DxM`` (batch and FSDP over ``data``; heads, ``mlp``, experts,
vocabulary and the sequence between layers over ``model``).  The
launchers spawn their own ranks when no process group is up.  The
reference's TPU constants (its roofline's peak rates) and its 512-chip
production mesh belong to the dry-run tools, which are not ported yet
(ROADMAP queue 1, item 6).
"""
from __future__ import annotations

from repro_torch.runtime.sharding import make_mesh_2d

AXES = ("data", "model")


def make_mesh(shape, axes=AXES, *, device=None):
    """A ``DeviceMesh`` of ``shape`` over ``axes``; only the 2-D
    ``("data", "model")`` layout is ported."""
    if tuple(axes) != AXES or len(shape) != 2:
        raise NotImplementedError(
            f"make_mesh{tuple(shape)} over {tuple(axes)}: the port builds "
            "the 2-D ('data', 'model') mesh only")
    return make_mesh_2d(shape[0], shape[1], device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``data`` x ``model`` mesh over the ranks there are (initialising a
    one-process group for 1x1 when none exists)."""
    return make_mesh_2d(data, model, device=device)
