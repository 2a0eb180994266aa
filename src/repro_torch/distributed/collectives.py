"""The one seam every collective of the port goes through.

The model's collectives (``distributed.tensor_parallel``'s, FSDP's
gathers, ``models.moe.routed_ep``'s exchange, sequence gather and aux
mean, and the training step's reductions in
``distributed.data_parallel``) call ``all_reduce``, ``all_gather``,
``reduce_scatter``, ``all_to_all_single`` and ``world_size`` here, never
``torch.distributed`` themselves. A group is one of:

* a live process group (a ``DeviceMesh``'s ``get_group``): the call is
  ``torch.distributed``'s, as the code made it before the seam;
* a ``CountedGroup`` (``launch.mesh.RankMesh``'s, the dry-run's stand-in
  for one rank of a larger mesh): nothing moves and ``torch.distributed``
  is never reached. The result is made locally with the collective's
  shape and the same aten ops as a live call around it (an all-reduce
  returns the tensor it was given, a gather ``ways`` blocks joined, a
  reduce-scatter one block, an all-to-all leaves the output its caller
  made), so that a count on ``meta`` tensors sees what a live rank runs;
  the values are not the collective's, so a counted group takes
  ``meta`` tensors only and refuses any other.

An axis of one rank has no group (``None``) on the dry-run's stand-in;
the callers keep that case as they had it (no call). A live mesh's axis
of one rank has a group of one, over which ``routed_ep`` calls its
exchange and mean (``RankMesh(one_rank_groups=True)`` counts them).

Every call, live or counted, is added to each active ``Tally``
(``recording``): its kind, group size and operand bytes; the dry-run's
``Counter`` holds one, and a live rank may record its own calls. The
kinds and operand bytes are those of the reference's HLO analysis
(``common/hlo.py``): an all-gather's operand is a rank's block, a
reduce-scatter's the whole tensor; traffic is the operand bytes times
``hlo._traffic_factor`` of the kind and group size (ring algorithms).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.hlo import _traffic_factor

#: the kinds, as the reference's HLO names them
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


@dataclasses.dataclass(frozen=True)
class CountedGroup:
    """The stand-in for the process group of an axis of ``size`` ranks
    named ``axis``: collectives over it are counted, not run."""
    axis: str
    size: int


class Tally:
    """Collective calls by ``(kind, group size)``: ``[count, operand
    bytes]``."""

    def __init__(self):
        self.calls: Dict[Tuple[str, int], List[int]] = {}

    def add(self, kind: str, ways: int, nbytes: int) -> None:
        rec = self.calls.setdefault((kind, ways), [0, 0])
        rec[0] += 1
        rec[1] += nbytes


def summarize(calls) -> dict:
    """``{(kind, group size): (count, operand bytes)}`` -> the record's
    ``collectives``, with the reference's keys: ``num_collectives``,
    ``total_operand_bytes``, ``total_traffic_bytes`` and ``by_kind``
    (each kind's ``count``, ``operand_bytes`` and ``traffic_bytes``)."""
    by_kind: Dict[str, dict] = {}
    for (kind, ways), (n, nbytes) in sorted(calls.items()):
        if not n:
            continue
        d = by_kind.setdefault(kind, {"count": 0, "operand_bytes": 0,
                                      "traffic_bytes": 0.0})
        d["count"] += n
        d["operand_bytes"] += nbytes
        d["traffic_bytes"] += nbytes * _traffic_factor(kind, ways)
    return {"num_collectives": sum(d["count"] for d in by_kind.values()),
            "total_operand_bytes": sum(d["operand_bytes"]
                                       for d in by_kind.values()),
            "total_traffic_bytes": sum(d["traffic_bytes"]
                                       for d in by_kind.values()),
            "by_kind": by_kind}


_TALLIES: List[Tally] = []


@contextlib.contextmanager
def recording(tally: Optional[Tally] = None) -> Iterator[Tally]:
    """Add every collective called while entered, on any thread (a
    backward may run on autograd's), to ``tally`` (a new one by
    default)."""
    tally = Tally() if tally is None else tally
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _note(kind: str, group, t: torch.Tensor) -> None:
    if _TALLIES:
        ways = world_size(group)
        nbytes = t.numel() * t.element_size()
        for tally in _TALLIES:
            tally.add(kind, ways, nbytes)


def counted(group) -> bool:
    return isinstance(group, CountedGroup)


def _live(group, t: torch.Tensor) -> bool:
    """Whether ``group`` is live; a counted group on a tensor that holds
    values raises (its result would not be the collective's)."""
    if not counted(group):
        return True
    if not t.is_meta:
        raise ValueError(f"a collective over the counted group {group} "
                         f"takes meta tensors, got one on {t.device}")
    return False


def world_size(group) -> int:
    """The ranks of ``group``."""
    return group.size if counted(group) else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (made contiguous first);
    returns the tensor reduced."""
    t = t.contiguous()
    _note("all-reduce", group, t)
    if _live(group, t):
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    t = t.contiguous()
    _note("all-gather", group, t)
    if _live(group, t):
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` of ``t``
    (``world_size(group)`` equal blocks)."""
    parts = [c.contiguous() for c in t.chunk(world_size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    _note("reduce-scatter", group, t)
    if _live(group, t):
        dist.reduce_scatter(out, parts, group=group)
    return out


def all_to_all_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``x``'s equal blocks, block j to rank j of ``group``, into
    ``out`` (the blocks that arrive, in rank order)."""
    _note("all-to-all", group, x)
    if _live(group, x):
        dist.all_to_all_single(out, x, group=group)
