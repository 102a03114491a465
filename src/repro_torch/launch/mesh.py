"""Production mesh construction.

The port of ``repro.launch.mesh``. ``repro`` builds its production meshes
over 256 or 512 fake CPU devices for the dry run; the port's are one
process's :class:`~repro_torch.distributed.mesh.DeviceMesh` that repeats
one device, the meta device by default: the dry run
(``launch.dryrun``) runs the real step on it without allocating.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed.mesh import DeviceMesh, make_mesh

__all__ = ["make_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str = "meta") -> DeviceMesh:
    """16 x 16 ``("data", "model")`` for one pod (256 cells) or 2 x 16 x 16
    ``("pod", "data", "model")`` for two (512 cells), every cell ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=[device] * math.prod(shape))
