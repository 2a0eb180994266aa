"""The mesh the port runs on: one card.

Port of the reference's ``launch/mesh.py``. The reference builds a
16 x 16 production mesh (and a 2 x 16 x 16 multi-pod one) of
placeholder devices; the port's production mesh is one card, axes
``("data", "model")`` of size 1 x 1. A ``Mesh`` here is plain data (axis
names and sizes): building one touches no device, so the dry-run runs
where there is no card. ``Mesh.shape`` is the mapping of axis sizes that
``repro_torch.distributed.sharding`` takes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.device import selected_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """One card: ``("data", "model")`` = 1 x 1. A multi-pod mesh has no
    meaning on one card and raises ``ValueError``."""
    if multi_pod:
        raise ValueError("one card: no multi-pod mesh")
    return Mesh(("data", "model"), (1, 1))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``data`` x ``model`` mesh over the devices of the selected kind
    (the visible cards, or the one CPU); asserts that they suffice."""
    dev = selected_device()
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    assert data * model <= n, (data, model, n)
    return Mesh(("data", "model"), (data, model))
