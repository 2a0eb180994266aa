"""The meshes the port runs on.

Port of the reference's ``launch/mesh.py``. The reference builds a
16 x 16 production mesh (and a 2 x 16 x 16 multi-pod one) of
placeholder devices; the port's production mesh, which the dry-run
counts for, is one card, axes ``("data", "model")`` of size 1 x 1. A
``Mesh`` here is plain data (axis names and sizes): building one touches
no device, so the dry-run runs where there is no card. ``Mesh.shape`` is
the mapping of axis sizes that ``repro_torch.distributed.sharding``
takes.

``make_host_mesh`` is the mesh a run computes on: a
``torch.distributed`` device mesh over the live process group, which
``sharding.make_context`` turns into the context of tensor parallelism
(``distributed.tensor_parallel``), the expert-parallel MoE path
(``models.moe.routed_ep``) and a training step on a mesh
(``distributed.data_parallel``). ``OneRankMesh`` is the dry-run's: the
same calls answered for one rank with no process group, so that the
dry-run counts what a run on the production mesh runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import current_device


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


@dataclasses.dataclass(frozen=True)
class OneRankMesh:
    """A mesh of one rank on every axis and no process group: the mesh of
    a context made from plain axis sizes (``sharding.make_context``, the
    dry-run's), as the reference's dry-run compiles on its mesh. It
    answers the ``DeviceMesh`` calls the model makes; ``get_group`` is
    ``None``, over which ``models.moe.routed_ep``'s exchange is a copy
    and the gradient reductions are nothing."""
    mesh_dim_names: Tuple[str, ...] = ("data", "model")

    def size(self, dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None


#: the process group's backend for each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_host_mesh(data: int = 1, model: int = 1,
                   backend: Optional[str] = None) -> DeviceMesh:
    """A ``data`` x ``model`` device mesh over the live process group, axes
    ``("data", "model")``; rank ``d·model + m`` is at ``(d, m)``, where
    the reference's ``jax.make_mesh`` puts device ``d·model + m``.

    ``backend`` is the process group's: by default NCCL on the card and
    gloo on the CPU (``BACKENDS``); a caller may name gloo on the card,
    which is how several ranks share one card (NCCL refuses two ranks on
    one device). With no process group yet and ``data·model == 1`` it
    starts a world of one on an in-process ``HashStore`` (no socket, no
    environment variables); the CPU is used only when the caller asked
    for it (``use_device("cpu")``). More ranks need a world of
    ``data·model`` ranks that the caller initialised; a group of another
    size or of another backend raises ``ValueError``."""
    dev = current_device()
    backend = backend or BACKENDS[dev.type]
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a {data} x {model} mesh needs an initialised "
                             f"world of {n} ranks")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1,
            device_id=dev if backend == "nccl" else None)
    if dist.get_world_size() != n or dist.get_backend() != backend:
        raise ValueError(
            f"a {data} x {model} mesh on {dev} wants a {backend} world of "
            f"{n}; the live one is {dist.get_backend()} of "
            f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
