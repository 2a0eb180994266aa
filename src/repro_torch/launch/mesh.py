"""The meshes the port runs on.

Port of the reference's ``launch/mesh.py``. ``make_production_mesh`` is
the reference's: one card, axes ``("data", "model")`` of size 1 x 1, for
the ``pod`` records (the port's pod record counts one H100, ROADMAP §3),
and the reference's multi-pod mesh, ``("pod", "data", "model")`` = 2 x 16
x 16: 512 H100s, counted, never run. A ``Mesh`` here is plain data (axis
names and sizes): building one touches no device, so the dry-run runs
where there is no card. ``Mesh.shape`` is the mapping of axis sizes
that ``repro_torch.distributed.sharding`` takes.

``make_host_mesh`` is the mesh a run computes on: a
``torch.distributed`` device mesh over the live process group, which
``sharding.make_context`` turns into the context of tensor parallelism
(``distributed.tensor_parallel``), the expert-parallel MoE path
(``models.moe.routed_ep``) and a training step on a mesh
(``distributed.data_parallel``). ``RankMesh`` is the dry-run's: the same
calls answered for one rank at a position of a mesh of any size, with
no process group; over an axis of more than one rank its group is a
``distributed.collectives.CountedGroup``, over which every collective is
counted and nothing moves, so that the dry-run counts what that rank of
the mesh runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import current_device
from repro_torch.distributed.collectives import CountedGroup


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
    """One card, ``("data", "model")`` = 1 x 1; with ``multi_pod`` the
    reference's ``("pod", "data", "model")`` = 2 x 16 x 16."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (1, 1))


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One rank of a mesh and no process group: the axis names, their
    sizes and this rank's coordinate on each (the origin by default; one
    rank of a 1 x 1 mesh with no arguments), as ``sharding.make_context``
    makes it from plain axis sizes for the dry-run. It answers the
    ``DeviceMesh`` calls the model makes; ``get_group`` of an axis of one
    rank is ``None`` (nothing is called over it: ``models.moe.routed_ep``'s
    exchange is a copy, the gradient reductions nothing), of a larger axis
    a ``CountedGroup`` naming it and its size. With ``one_rank_groups``
    an axis of one rank has a ``CountedGroup`` of size 1 too, as a live
    ``DeviceMesh``'s axis has a process group of one rank: the stand-in
    of a live rank, whose ``routed_ep`` exchanges and takes its mean over
    a model group of one rank."""
    mesh_dim_names: Tuple[str, ...] = ("data", "model")
    sizes: Tuple[int, ...] = (1, 1)
    coords: Optional[Tuple[int, ...]] = None
    one_rank_groups: bool = False

    def __post_init__(self):
        if len(self.sizes) != len(self.mesh_dim_names):
            raise ValueError(f"axes {self.mesh_dim_names}, sizes "
                             f"{self.sizes}")
        coords = self.coords or (0,) * len(self.sizes)
        if len(coords) != len(self.sizes) or any(
                not 0 <= c < n for c, n in zip(coords, self.sizes)):
            raise ValueError(f"coordinates {coords} on a mesh of "
                             f"{self.sizes}")
        object.__setattr__(self, "coords", tuple(coords))

    def _dim(self, mesh_dim: Union[int, str]) -> int:
        return self.mesh_dim_names.index(mesh_dim) \
            if isinstance(mesh_dim, str) else mesh_dim

    def size(self, dim: Union[None, int, str] = None) -> int:
        return math.prod(self.sizes) if dim is None \
            else self.sizes[self._dim(dim)]

    def get_local_rank(self, mesh_dim: Union[None, int, str] = None) -> int:
        return self.coords[self._dim(0 if mesh_dim is None else mesh_dim)]

    def get_group(self, mesh_dim: Union[None, int, str] = None
                  ) -> Optional[CountedGroup]:
        dim = self._dim(0 if mesh_dim is None else mesh_dim)
        if self.sizes[dim] == 1 and not self.one_rank_groups:
            return None
        return CountedGroup(self.mesh_dim_names[dim], self.sizes[dim])


#: the process group's backend for each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1,
                   backend: Optional[str] = None) -> DeviceMesh:
    """A ``data`` x ``model`` device mesh over the live process group, axes
    ``("data", "model")``; rank ``d·model + m`` is at ``(d, m)``, where
    the reference's ``jax.make_mesh`` puts device ``d·model + m``. With
    ``pod > 1`` the axes are ``("pod", "data", "model")`` and rank
    ``(p·data + d)·model + m`` is at ``(p, d, m)``, in the same order.

    ``backend`` is the process group's: by default NCCL on the card and
    gloo on the CPU (``BACKENDS``); a caller may name gloo on the card,
    which is how several ranks share one card (NCCL refuses two ranks on
    one device). With no process group yet and one rank in all it
    starts a world of one on an in-process ``HashStore`` (no socket, no
    environment variables); the CPU is used only when the caller asked
    for it (``use_device("cpu")``). More ranks need a world of
    ``pod·data·model`` ranks that the caller initialised; a group of
    another size or of another backend raises ``ValueError``."""
    dev = current_device()
    backend = backend or BACKENDS[dev.type]
    n = pod * data * model
    what = f"a {data} x {model} mesh" if pod == 1 else \
        f"a {pod} x {data} x {model} mesh"
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"{what} needs an initialised world of {n} "
                             f"ranks")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1,
            device_id=dev if backend == "nccl" else None)
    if dist.get_world_size() != n or dist.get_backend() != backend:
        raise ValueError(
            f"{what} on {dev} wants a {backend} world of {n}; the live one "
            f"is {dist.get_backend()} of {dist.get_world_size()}")
    if pod > 1:
        return init_device_mesh(dev.type, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
