"""Dry-run engine: count every (arch x shape) cell on ``meta`` tensors and
write the roofline artifacts.

Port of the reference's ``launch/dryrun_lib.py``, for one rank of a
mesh of H100s. The reference lowers and compiles each cell with XLA and
reads the compiled HLO (``common/hlo.py``); the port makes no HLO. It runs each cell's step
(``make_train_step``, ``model.prefill``, ``model.decode_step``) on
``meta`` tensors, which carry shapes and dtypes and no memory, under one
``TorchDispatchMode`` (``Counter``) that sees every aten op and counts:

* FLOPs by ``hlo.py``'s rules: a matmul (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``; ``einsum`` and ``@`` reach these) 2·M·N·K, as
  ``torch.utils.flop_counter`` counts it; a pointwise op one FLOP per
  output element; a reduction its input's elements; a softmax five per
  element; copies, casts, indexing and factories none;
* bytes: the operand and output bytes of every op that is not a view, a
  reshape or a metadata op (``hlo.py``'s memory model without fusion,
  which is also eager PyTorch's on the card: it does not fuse); indexing
  reads only what it gathers (2 x the output), a scatter or
  ``index_put`` 3 x its update, a ``copy_`` its source and destination;
* memory: the bytes of the live storages after every op. Storages, not
  tensors: autograd keeps saved tensors alive in C++ after their Python
  objects are gone, and a storage's Python object lives exactly as long
  as its C++ storage, so a weak reference to it ends when the storage
  does.

Under ``ctx_overrides["fused_scopes"]`` (a pseudo-key, as in the
reference) an op inside a named scope of that list
(``models.layers.named_scope``) keeps its FLOPs and loses its bytes,
except that the first read of a storage made outside every fused scope
counts its bytes once. With ``["vmem_flash"]`` the KV-block body of the
plain attention loop is counted as the flash kernels move it: its inputs
(each q block, k, v, the running state) read once, its intermediates
never written. The q block's float32 cast, the state's zeros and the
final normalisation lie outside the scope, as in the reference, and stay
counted as eager ops; so does the backward of the scope's ops, which
runs outside it (on the card it is plain float32 math).

Replayed attention: a prefill's plain attention loop is most of a cell's
aten ops (``prefill_32k``: 1,024 blocks of ~66 ops a layer, ~6 s of
counting each), and every call with the same inputs counts the same.
Within one ``count_cell``, the first call of ``models.layers.attention``
with a given signature (each input's shape, strides, dtype, storage
size and flags, the call's arguments and scopes) runs under the
``Counter`` and its increments are kept: FLOPs, matmul FLOPs, bytes,
ops, the rise of live bytes at its peak and at its end, and the flags
it left on its inputs' storages. A later call with that signature adds
the same increments and returns an output of the same layout without
running the loop. A call whose inputs need a gradient always runs (the
backward needs its graph), and so does a decode step's one-row call.
``count_cell(..., replay=False)`` runs every call;
``tests/test_torch_dryrun.py`` and ``tests/test_torch_dryrun_stages.py``
hold the two equal.

The meta path never reaches a kernel: ``layers._flash_case`` needs a
CUDA tensor, so attention takes the plain chunked loop, which is the
computation the reference's HLO holds (its models never launch the
Pallas kernel). Nothing is allocated on any device.

Depth by repeat: the counterpart of ``hlo.py``'s while-loop trip
counts. A plan is a list of stages, each a block of layers repeated
``R_s`` times (one stage for the dense, SSM, hybrid and audio families;
the MoE family's leading dense layers and its MoE layers; the
local/global family's blocks of window layers and a global one, then its
remaining window layers). Every count is linear in each stage's repeat,
so a cell is counted at a base of small repeats and at one more block of
each stage that repeats beyond it, and extrapolated:
``f(R) = f(b) + sum_s (R_s - b_s) (f(b + e_s) - f(b))``. The base repeats
every stage once but the last, which it repeats twice (``b_s = min(R_s,
1)``, ``b_last = min(R_last, 2)``), so that the plan's last block has a
block of its own kind before it, as at full depth: the one-stage
families are counted at depths 2 and 3 (2 and 3 super-blocks for the
hybrid family, each with its application of the shared attention);
``gemma3-4b`` (5 x [5 window + 1 global], then 4 window) at 1+2, 2+2
and 1+3 blocks, 31 layers instead of 34 in three counts;
``deepseek-moe-16b`` (1 dense, then 27 MoE) at 1+2 and 1+3. A plan whose
every stage repeats at most once past its base is counted whole. FLOPs,
bytes, argument and output bytes are sums over layers (a shared layer's
parameters count once at every depth), so this is exact; so is the peak
wherever it falls at the same point of the last block, which a plan of
one block misses in prefill (no layer before it holds its raw k and v
while the next one runs). A train step's peak is kept in two regions,
outside and inside the optimizer's update (the ``optimizer`` scope of
``train_step``), each extrapolated on its own and the larger taken: the
backward's peak grows by a layer's parameters, gradients and saved
input, the functional AdamW's by its parameters, moments and their new
copies, so a deep cell's peak can move from the first to the second
(``musicgen-medium`` at 2 x 2048: 25.5 GB from the backward at depths
2 and 3 extrapolated, 40.3 GB measured, AdamW's). Past that point the
backward's own peak may move too, to its end, where every gradient is
live; that point is where the optimizer's region starts, below its
peak, so the cell's peak stays exact. ``tests/test_torch_dryrun.py`` holds both
against ``unroll=True`` for one stage, ``test_torch_dryrun_stages.py``
for two.

A cell is counted for one rank of a mesh (``run_cell``'s ``mesh``, by
default a production mesh of ``launch.mesh``: the pod record's one card,
1 x 1, or the reference's multi-pod mesh, 2 x 16 x 16), the rank at its
origin (``count_cell`` of a context on any ``RankMesh`` counts another).
Its context is ``sharding.make_context`` of ``launch.mesh.RankMesh``,
the rank with no process group, and ``moe_impl="ep"``, as the
reference's; its arguments
are the rank's own (``_build``): its block of the parameters and of the
training state on both axes (``convert.local_tp_keep``: its heads, FFN
units, vocabulary rows and experts over ``model``, its FSDP block over
``data``), its rows of the batch over the data axes (``local_rows``:
every row where the batch does not divide, as the reference's
``batch_specs``), its caches by the port's heads (and by its rows of
their sequence where the batch does not divide over the data axes or
the KV heads over ``model``) and its rows of the
VLM's image embeddings. The step then runs as that rank runs it, and
every collective it calls goes through ``distributed.collectives``:
over the stand-in's ``CountedGroup`` nothing moves and the result is
made locally, and ``count`` tallies each by kind and group size (count
and operand bytes; the forward, the backward and the remat recompute,
a shared layer's FSDP gathers at each application). Those sums join the
others in depth by repeat (every collective is a layer's, so linear in
each stage's repeat); a replayed attention call has none. ``run_cell``
writes them as the reference's ``collectives`` (``num_collectives``,
``total_operand_bytes``, ``total_traffic_bytes`` by ``hlo.py``'s ring
factors, ``by_kind``), and the roofline is ``common.hw.roofline_terms``
at the card's dense bf16 rate, its ``collective_s`` the traffic over one
NVLink link, as the reference's convention. Over an axis of one rank
there is no group and nothing is called (the pod record's ``routed_ep``
exchange is a copy, its reductions nothing). A live rank's own count
(``count`` on its real tensors, under a live ``DeviceMesh``) equals the
stand-in's at its coordinates (a ``RankMesh`` with ``one_rank_groups``,
as a live mesh has a group on an axis of one rank);
``tests/test_torch_dryrun_mesh.py`` holds them equal on gloo meshes.
The dense, MoE, SSM, hybrid, audio and local/global families, MLA and
MTP (``deepseek-v3-671b``) and the VLM family
(``llama-3.2-vision-90b``, its ``image_embeds`` an argument of every
cell) are counted: all ten of the reference's architectures (the
SSD scan has no host read and no data-dependent shape). A MoE layer
counts ``routed_ep`` as the reference compiles it, every expert over
its buffer of ``cap = ceil(T·k / E · capacity_factor)`` rows of the
rank's tokens. A batch that does not divide over the data axes
(``long_500k``'s 1) is replicated, and its attention caches are cut on
the sequence over them, as the reference's ``cache_specs`` cuts them;
the MLA latent cache is cut over the model axis as there, and a GQA
block whose KV heads do not divide over the model axis runs the
reference's context-parallel attention (its leaves cut, its query rows
split, its decode caches' sequence cut over ``model``). Where the port's
layout is not the reference's (a batch-1 Mamba2 state is whole over the
data axes), the port's is counted (ROADMAP §3).
``ctx_overrides`` may set ``moe_impl="dense"`` (the drop-free
``routed``, counted under even load, ``moe.expert_rows``) and
``capacity_factor``. ``long_500k`` for the full-attention archs (the
reference's reason) gets a ``skipped`` record on either mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common import hw
from repro_torch.configs import SHAPES, get_config, list_configs, \
    shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shardlib
from repro_torch.launch import specs as speclib
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import convert, layers, model
from repro_torch.models.layers import ModelContext, ShapesOnly, \
    current_scopes
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_step import OPTIMIZER_SCOPE, \
    make_train_state, make_train_step

#: the scope the plain attention loop's KV-block body runs in
FLASH_SCOPE = "vmem_flash"

aten = torch.ops.aten

# ------------------------------------------------------------------ rules
_FREE, _MM, _BMM, _POINTWISE, _REDUCE, _SOFTMAX, _COPY, _GATHER, \
    _SCATTER, _WRITE, _OTHER = range(11)


def _ops(*names: str) -> set:
    """The aten overloads named ``"op.overload"`` that this torch has."""
    found = set()
    for name in names:
        packet, _, overload = name.partition(".")
        op = getattr(getattr(aten, packet, None), overload, None)
        if op is not None:
            found.add(op)
    return found


#: ops that move no bytes and do no arithmetic: metadata, allocation
#: without a fill, and aliases that are not marked as views
_FREE_OPS = _ops(
    "detach.default", "_unsafe_view.default", "alias.default",
    "lift_fresh.default", "empty.memory_format", "empty_strided.default",
    "new_empty.default", "new_empty_strided.default", "empty_like.default",
    "_local_scalar_dense.default", "sym_size.int", "sym_stride.int",
    "sym_numel.default", "sym_storage_offset.default",
    "is_same_size.default", "set_.source_Storage_storage_offset")
#: factories and fills: they write their output and compute nothing
_WRITE_OPS = _ops(
    "zeros.default", "ones.default", "full.default", "arange.default",
    "arange.start", "arange.start_step", "scalar_tensor.default",
    "zeros_like.default", "ones_like.default", "full_like.default",
    "new_zeros.default", "new_ones.default", "new_full.default",
    "fill_.Scalar", "fill_.Tensor", "zero_.default")
#: gathers read only what they return (``hlo.py``: 2 x the output)
_GATHER_OPS = _ops("index.Tensor", "gather.default", "index_select.default",
                   "embedding.default")
#: scatters read the region and the update and write the region
#: (``hlo.py``: 3 x the update); the update is the last tensor argument
_SCATTER_OPS = _ops("index_put.default", "index_put_.default",
                    "_index_put_impl_.default", "scatter.src", "scatter_.src",
                    "scatter_add.default", "scatter_add_.default",
                    "index_add.default", "index_add_.default")
_SOFTMAX_OPS = _ops("_softmax.default", "_log_softmax.default",
                    "_softmax_backward_data.default",
                    "_log_softmax_backward_data.default")
# a matmul's two factors are its last two tensor arguments
_RULES: Dict[Any, int] = {aten.mm.default: _MM, aten.bmm.default: _BMM,
                          aten.addmm.default: _MM,
                          aten.baddbmm.default: _BMM,
                          aten.copy_.default: _COPY,
                          # a copy, tagged pointwise: no arithmetic
                          aten.clone.default: _OTHER,
                          # in place, untagged: one FLOP an element
                          aten.masked_fill_.Scalar: _POINTWISE}
_RULES.update({op: _FREE for op in _FREE_OPS})
_RULES.update({op: _WRITE for op in _WRITE_OPS})
_RULES.update({op: _GATHER for op in _GATHER_OPS})
_RULES.update({op: _SCATTER for op in _SCATTER_OPS})
_RULES.update({op: _SOFTMAX for op in _SOFTMAX_OPS})
#: the namespaces of ``torch.distributed``'s ops, which a live rank's
#: collectives dispatch as
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional"})
_POINTWISE_TAG = torch.Tag.pointwise
_REDUCTION_TAG = getattr(torch.Tag, "reduction", None)


def _rule(func) -> int:
    rule = _RULES.get(func)
    if rule is None:
        if func.is_view:
            rule = _FREE
        elif _POINTWISE_TAG in func.tags:
            rule = _POINTWISE
        elif _REDUCTION_TAG is not None and _REDUCTION_TAG in func.tags:
            rule = _REDUCE
        else:
            rule = _OTHER
        _RULES[func] = rule
    return rule


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements (a broadcast dim counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(args, kwargs) -> list:
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    if kwargs:
        out.extend(v for v in kwargs.values() if isinstance(v, torch.Tensor))
    return out


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return []


def _leaves(tree) -> Iterable[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------ counting
_MADE_FUSED, _READ_FUSED = 1, 2     # storage flags


class Counter(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage bytes of every aten op run
    under it (see the module docstring). ``fused_scopes``: scope names
    whose ops keep their FLOPs and lose their bytes."""

    def __init__(self, fused_scopes: Tuple[str, ...] = ()):
        super().__init__()
        self.fused_scopes = frozenset(fused_scopes)
        self.flops = 0
        self.matmul_flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        # the peak outside and inside the optimizer's scope
        self.region_peak = {"step": 0, OPTIMIZER_SCOPE: 0}
        # id(storage) -> [weakref, nbytes, flags]
        self._storages: Dict[int, list] = {}
        self.silent = False     # run ops without counting them
        # the collectives called while counting (``count`` records them)
        self.tally = collectives.Tally()

    # -- storages
    def _gone(self, key: int, nbytes: int) -> Callable:
        def done(_ref):
            self.live -= nbytes
            self._storages.pop(key, None)
        return done

    def track(self, t: torch.Tensor, flags: int = 0) -> None:
        """Note ``t``'s storage as live (once)."""
        st = t.untyped_storage()
        key = id(st)
        if key not in self._storages:
            nbytes = st.nbytes()
            self._storages[key] = [weakref.ref(st, self._gone(key, nbytes)),
                                   nbytes, flags]
            self.live += nbytes
            self.note_peak(self.live)

    def note_peak(self, nbytes: int) -> None:
        """Live bytes reached ``nbytes``: raise the peak and the peak of
        the region the thread is in."""
        self.peak = max(self.peak, nbytes)
        region = OPTIMIZER_SCOPE if OPTIMIZER_SCOPE in current_scopes() \
            else "step"
        self.region_peak[region] = max(self.region_peak[region], nbytes)

    def _fused_read_bytes(self, t: torch.Tensor) -> int:
        """Inside a fused scope: the bytes of ``t``'s storage the first
        time a fused region reads it, if it was made outside one."""
        rec = self._storages.get(id(t.untyped_storage()))
        if rec is None:
            return _nbytes(t)
        if rec[2]:
            return 0
        rec[2] |= _READ_FUSED
        return rec[1]

    # -- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a live rank's collectives are the seam's to count
        # (``distributed.collectives``), not ops of their own
        if self.silent or func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        self.ops += 1
        outs = _outputs(out)
        fused = bool(self.fused_scopes) and \
            not self.fused_scopes.isdisjoint(current_scopes())
        for o in outs:      # a view's storage is known; ``empty``'s is new
            self.track(o, _MADE_FUSED if fused else 0)
        rule = _rule(func)
        if rule == _FREE:
            return out
        ins = _tensors(args, kwargs)
        flops = 0
        if rule == _MM:
            a, b = ins[-2], ins[-1]
            flops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
            self.matmul_flops += flops
        elif rule == _BMM:
            a, b = ins[-2], ins[-1]
            flops = 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            self.matmul_flops += flops
        elif rule == _POINTWISE:
            flops = sum(o.numel() for o in outs)
        elif rule == _REDUCE:
            flops = ins[0].numel() if ins else 0
        elif rule == _SOFTMAX:
            flops = 5 * outs[0].numel()
        self.flops += flops
        if fused:
            self.bytes += sum(self._fused_read_bytes(t) for t in ins)
            return out
        if rule == _GATHER:
            self.bytes += 2 * sum(_nbytes(o) for o in outs)
        elif rule == _SCATTER:
            self.bytes += 3 * _nbytes(ins[-1])
        elif rule == _COPY:
            self.bytes += _nbytes(ins[0]) + _nbytes(ins[1])
        elif rule == _WRITE:
            self.bytes += sum(_nbytes(o) for o in outs)
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(o) for o in outs)
        return out


def _track_arguments(args, counter: Counter) -> Tuple[int, set]:
    """Track every argument storage; returns their bytes, with each
    Python int counted as the reference's int32 scalar (decode's
    position), and the storages' ids."""
    total = 0
    ids = set()
    for leaf in _leaves(args):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            if id(st) not in ids:
                ids.add(id(st))
                total += st.nbytes()
                counter.track(leaf)
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            total += speclib.SCALAR_BYTES
    return total, ids


_TOTALS = ("flops", "matmul_flops", "bytes", "ops")


class _AttentionReplay:
    """While entered, ``layers.attention`` called on this thread under
    ``counter`` is counted once per signature and replayed after (module
    docstring). ``memo`` maps signatures to increments and may be shared
    by the counts of one cell."""

    def __init__(self, counter: Counter, memo: dict):
        self.counter, self.memo = counter, memo
        self.thread = threading.get_ident()
        self.real = None

    def __enter__(self):
        self.real = layers.attention
        layers.attention = self.attention
        return self

    def __exit__(self, *exc):
        layers.attention = self.real

    def _signature(self, tensors, kwargs):
        parts, ids = [], []
        for t in tensors:
            st = t.untyped_storage()
            rec = self.counter._storages.get(id(st))
            ids.append(id(st))
            parts.append((tuple(t.shape), t.stride(), t.storage_offset(),
                          t.dtype, st.nbytes(), rec[2] if rec else None))
        return (tuple(parts), tuple(ids.index(i) for i in ids),
                tuple(sorted(kwargs.items())), current_scopes())

    def attention(self, q, k, v, **kwargs):
        c = self.counter
        tensors = (q, k, v)
        if threading.get_ident() != self.thread or q.shape[1] == 1 or (
                torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            return self.real(q, k, v, **kwargs)
        key = self._signature(tensors, kwargs)
        hit = self.memo.get(key)
        if hit is not None:
            for name, n in zip(_TOTALS, hit["totals"]):
                setattr(c, name, getattr(c, name) + n)
            c.note_peak(c.live + hit["peak"])
            c.silent = True
            try:
                out = torch.empty_strided(hit["shape"], hit["stride"],
                                          dtype=hit["dtype"], device=q.device)
            finally:
                c.silent = False
            c.track(out)
            for t, flags in zip(tensors, hit["flags"]):
                rec = c._storages.get(id(t.untyped_storage()))
                if rec is not None:
                    rec[2] |= flags
            return out
        totals0 = [getattr(c, name) for name in _TOTALS]
        live0, peak0 = c.live, c.peak
        c.peak = live0
        out = self.real(q, k, v, **kwargs)
        rise, c.peak = c.peak - live0, max(peak0, c.peak)
        st = out.untyped_storage()
        rec = c._storages.get(id(st))
        # replayable if the call's only lasting storage is its own output
        if rec is not None and not rec[2] and out.storage_offset() == 0 \
                and c.live - live0 == st.nbytes() == \
                out.numel() * out.element_size():
            self.memo[key] = {
                "totals": [getattr(c, name) - n
                           for name, n in zip(_TOTALS, totals0)],
                "peak": rise, "shape": tuple(out.shape),
                "stride": out.stride(), "dtype": out.dtype,
                "flags": [c._storages.get(id(t.untyped_storage()),
                                          (None, None, 0))[2]
                          for t in tensors]}
        return out


def count(fn: Callable, args: tuple, *,
          fused_scopes: Tuple[str, ...] = (),
          memo: Optional[dict] = None) -> Dict[str, int]:
    """Run ``fn(*args)`` (on meta tensors) under a ``Counter``: FLOPs,
    matmul FLOPs, bytes, aten ops, and the argument, output, alias and
    peak bytes (the peak of live storage bytes, arguments included).
    ``memo``: the attention calls to replay (module docstring), shared
    by the counts of one cell; None runs every call."""
    counter = Counter(fused_scopes)
    arg_bytes, arg_ids = _track_arguments(args, counter)
    with counter, collectives.recording(counter.tally):
        if memo is None:
            out = fn(*args)
        else:
            with _AttentionReplay(counter, memo):
                out = fn(*args)
    out_bytes = alias_bytes = 0
    seen = set()
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out_bytes += st.nbytes()
            if id(st) in arg_ids:
                alias_bytes += st.nbytes()
    out = {"flops": counter.flops, "matmul_flops": counter.matmul_flops,
           "bytes": counter.bytes, "ops": counter.ops,
           "argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "alias_bytes": alias_bytes, "peak_bytes": counter.peak,
           "step_peak_bytes": counter.region_peak["step"],
           "optimizer_peak_bytes": counter.region_peak[OPTIMIZER_SCOPE]}
    for (kind, ways), (n, nbytes) in counter.tally.calls.items():
        out[f"{_COLL} {kind} {ways} count"] = n
        out[f"{_COLL} {kind} {ways} operand_bytes"] = nbytes
    return out


#: the prefix of a count's collective sums (``count``): one count and one
#: operand-bytes sum a kind and group size, extrapolated by depth like
#: every other sum
_COLL = "collective"


def collectives_of(counts: Dict[str, int]) -> dict:
    """A count's (``count``, ``count_cell``) collectives as the record's
    ``collectives`` (``distributed.collectives.summarize``)."""
    calls: Dict[Tuple[str, int], list] = {}
    for key, n in counts.items():
        if key.startswith(_COLL + " "):
            _, kind, ways, what = key.split(" ")
            rec = calls.setdefault((kind, int(ways)), [0, 0])
            rec[what == "operand_bytes"] = n
    return collectives.summarize(calls)


# ------------------------------------------------------------------ cells
def local_rows(batch: int, ctx: ModelContext) -> int:
    """The rows of a global batch of ``batch`` that a rank of ``ctx``'s
    mesh takes: its share over the data axes, or every row where the
    batch does not divide over them (replicated, as the reference's
    ``batch_specs``: ``long_500k``'s batch of 1; its decode caches are
    then cut on the sequence, ``ModelContext.batch_replicated``)."""
    D = ctx.data_axes_size
    return batch // D if batch % D == 0 else batch


def _build(cfg: ModelConfig, shape: ShapeConfig, ctx: ModelContext, *,
           opt_cfg: Optional[OptimizerConfig] = None,
           microbatch: int = 0) -> Tuple[Callable, tuple]:
    """(step function, meta arguments) of one cell of ``cfg`` on the rank
    of ``ctx``'s mesh: its block of the parameters and of the training
    state (``convert.local_tp_keep``), its rows of the batch and of the
    VLM's image embeddings (``local_rows``) and its caches, by the port's
    heads and, for a batch that does not divide over the data axes or KV
    heads that do not divide over the model axis, its rows of their
    sequence (``model.init_cache``)."""
    keep = convert.local_tp_keep(cfg, ctx)
    local = dataclasses.replace(shape,
                                global_batch=local_rows(shape.global_batch,
                                                        ctx))
    if shape.global_batch % ctx.data_axes_size:
        # every data rank holds the batch: the caches' sequence is cut
        ctx = dataclasses.replace(ctx, batch_replicated=True)
    if shape.kind == "train":
        opt_cfg = opt_cfg or OptimizerConfig()
        state = make_train_state(ShapesOnly(), cfg, opt_cfg, keep=keep)
        batch = speclib.train_batch_specs(cfg, local)
        return (make_train_step(cfg, ctx, opt_cfg, microbatch=microbatch),
                (state, batch))
    params = model.init(ShapesOnly(), cfg, keep=keep)
    if shape.kind == "prefill":
        inputs = speclib.prefill_inputs(cfg, local)

        def fn(params, tokens, image_embeds=None):
            return model.prefill(params, tokens, cfg, ctx,
                                 cache_len=shape.seq_len,
                                 image_embeds=image_embeds)
        args = (params, inputs["tokens"])
    elif shape.kind == "decode":
        inputs = speclib.decode_inputs(cfg, local, ctx=ctx)

        def fn(params, caches, token, pos, image_embeds=None):
            return model.decode_step(params, caches, token, pos, cfg, ctx,
                                     image_embeds=image_embeds)
        args = (params, inputs["caches"], inputs["token"], inputs["pos"])
    else:
        raise ValueError(shape.kind)
    if "image_embeds" in inputs:        # the VLM family's stub image
        args += (inputs["image_embeds"],)
    return fn, args


def split_overrides(ctx_overrides: Optional[dict]
                    ) -> Tuple[Dict[str, Any], int, Tuple[str, ...]]:
    """ctx_overrides -> (ModelContext fields, microbatch, fused scopes);
    raises ``ValueError`` for a reference-only or unknown field."""
    over = dict(ctx_overrides or {})
    microbatch = over.pop("microbatch", 0)
    fused = tuple(over.pop("fused_scopes", ()))
    over.setdefault("remat", "full")
    shardlib.check_context_fields(over)
    return over, microbatch, fused


def build_cell(arch: str, shape_name: str, mesh: Mesh, *,
               ctx_overrides: Optional[dict] = None):
    """Returns (step function, meta arguments) for a cell."""
    over, microbatch, _ = split_overrides(ctx_overrides)
    ctx = shardlib.make_context(mesh.shape, **over)
    return _build(get_config(arch), SHAPES[shape_name], ctx,
                  microbatch=microbatch)


def _repeats(cfg: ModelConfig) -> Tuple[int, ...]:
    """The repeats of ``cfg``'s stages, in plan order (a stage repeats a
    layer or a block, such as the hybrid family's six Mamba2 layers and
    a shared attention)."""
    return tuple(stage.repeat for stage in cfg.plan())


def _at_depth(cfg: ModelConfig, repeats: Tuple[int, ...]) -> ModelConfig:
    """``cfg`` with its stages repeated ``repeats`` times, each stage's
    block unchanged: ``num_layers`` counts every stage's layers but its
    shared ones (the hybrid family's 54 are 9 blocks of 6 Mamba2 layers,
    ``gemma3-4b``'s 34 are 5 blocks of 6 and 4), and the MoE family's
    first stage is its ``first_dense_layers``. Raises ``ValueError`` if
    the config's plan has no such cut."""
    stages = cfg.plan()
    own = [sum(not spec.shared for spec in st.layers) for st in stages]
    over = {"num_layers": sum(r * n for r, n in zip(repeats, own))}
    if cfg.family == "moe" and cfg.first_dense_layers:
        over["first_dense_layers"] = repeats[0]
    cut = dataclasses.replace(cfg, **over)
    if [(st.repeat, st.layers) for st in cut.plan()] != \
            [(r, st.layers) for r, st in zip(repeats, stages)]:
        raise ValueError(f"{cfg.name} has no cut with stage repeats "
                         f"{repeats}")
    return cut


def depth_points(repeats: Tuple[int, ...]
                 ) -> Tuple[Tuple[int, ...], Dict[int, Tuple[int, ...]]]:
    """(the base repeats, {stage: the base with one more block of it})
    of depth by repeat (module docstring); only stages that repeat past
    their base get a point."""
    base = tuple(min(r, 1) for r in repeats[:-1]) + (min(repeats[-1], 2),)
    more = {s: base[:s] + (base[s] + 1,) + base[s + 1:]
            for s, r in enumerate(repeats) if r > base[s]}
    return base, more


def count_cell(cfg: ModelConfig, shape: ShapeConfig, ctx: ModelContext, *,
               opt_cfg: Optional[OptimizerConfig] = None,
               microbatch: int = 0, fused_scopes: Tuple[str, ...] = (),
               unroll: bool = False, replay: bool = True
               ) -> Dict[str, int]:
    """The counts of one cell at ``cfg``'s depth: every layer
    (``unroll``), or by repeat (``depth_points``, extrapolated); with
    attention calls replayed (``replay``, module docstring) or each
    run."""
    memo = {} if replay else None

    def at(c):
        fn, args = _build(c, shape, ctx, opt_cfg=opt_cfg,
                          microbatch=microbatch)
        return count(fn, args, fused_scopes=fused_scopes, memo=memo)

    repeats = _repeats(cfg)
    base, more = depth_points(repeats)
    if unroll or all(r <= b + 1 for r, b in zip(repeats, base)):
        out = at(cfg)
    else:
        f0 = at(_at_depth(cfg, base))
        out = dict(f0)
        for s, point in more.items():
            fs = at(_at_depth(cfg, point))
            for k in set(out) | set(fs):
                out[k] = out.get(k, 0) + (repeats[s] - base[s]) * (
                    fs.get(k, 0) - f0.get(k, 0))
    # each region's peak is extrapolated on its own, their maximum is not
    # linear: the optimizer's grows faster and overtakes a deep cell's
    # backward (module docstring)
    out["peak_bytes"] = max(out.pop("step_peak_bytes"),
                            out.pop("optimizer_peak_bytes"))
    return out


def _skip(arch: str, shape_name: str, reason: str) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape_name, "status": "skipped",
            "reason": reason}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh: Optional[Mesh] = None,
             ctx_overrides: Optional[dict] = None,
             unroll: bool = False) -> Dict[str, Any]:
    """Count one cell on the rank at the origin of ``mesh`` (by default
    the production mesh, ``multi_pod``'s); return the roofline artifact
    dict.

    ctx_overrides may carry the pseudo-keys ``fused_scopes`` (scope
    names whose ops the flash kernels keep on chip) and ``microbatch``;
    the rest override ModelContext fields, and a reference-only or
    unknown field raises ``ValueError``."""
    over, microbatch, fused = split_overrides(ctx_overrides)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return _skip(arch, shape_name, why)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    t0 = time.perf_counter()
    try:
        ctx = shardlib.make_context(mesh.shape, **over)
        c = count_cell(cfg, shape, ctx, microbatch=microbatch,
                       fused_scopes=fused, unroll=unroll)
    except Exception as e:  # noqa: BLE001 - an error is the cell's record
        return {"arch": arch, "shape": shape_name, "status": "error",
                "mesh": list(mesh.shape.values()),
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:]}
    t_count = time.perf_counter() - t0

    flops, bytes_accessed = c["flops"], c["bytes"]
    coll = collectives_of(c)
    terms = hw.roofline_terms(flops, bytes_accessed,
                              coll["total_traffic_bytes"])
    mf_total = speclib.model_flops(cfg, shape)
    mf_per_chip = mf_total / n_dev
    temp = c["peak_bytes"] - c["argument_bytes"]
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": {k: int(v) for k, v in mesh.shape.items()},
        "num_devices": int(n_dev),
        "lower_s": t_count, "compile_s": 0.0,
        "counted": FLASH_SCOPE if FLASH_SCOPE in fused else "plain",
        "memory": {
            "argument_bytes": c["argument_bytes"],
            "output_bytes": c["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": c["alias_bytes"],
            "peak_hbm_proxy_bytes": c["peak_bytes"],
            "fits_hbm": c["peak_bytes"] < hw.H100_SXM.hbm_bytes,
        },
        "cost": {"flops_per_chip": flops,
                 "bytes_per_chip": bytes_accessed,
                 "matmul_flops_per_chip": c["matmul_flops"],
                 "aten_ops": c["ops"],
                 "depth": "unrolled" if unroll else "by_repeat",
                 "max_loop_trip": max(_repeats(cfg))},
        "collectives": coll,
        "roofline": terms,
        "model_flops_total": mf_total,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / flops) if flops else 0.0,
    }


def all_archs() -> list:
    """The reference's ten architectures, every one of them the port's."""
    return list_configs()


def run_matrix(archs, shapes, *, multi_pod: bool, out_dir: str,
               force: bool = False, ctx_overrides: Optional[dict] = None,
               tag: str = "", unroll: bool = False) -> list:
    os.makedirs(out_dir, exist_ok=True)
    mesh = make_production_mesh(multi_pod=multi_pod)
    results = []
    mesh_name = ("multipod" if multi_pod else "pod") + (f"-{tag}" if tag
                                                        else "")
    for arch in archs:
        for shape_name in shapes:
            fn = os.path.join(out_dir,
                              f"{arch}__{shape_name}__{mesh_name}.json")
            if os.path.exists(fn) and not force:
                with open(fn) as f:
                    results.append(json.load(f))
                print(f"[cached] {arch} x {shape_name} x {mesh_name}")
                continue
            print(f"[run]    {arch} x {shape_name} x {mesh_name} ...",
                  flush=True)
            res = run_cell(arch, shape_name, multi_pod=multi_pod, mesh=mesh,
                           ctx_overrides=ctx_overrides, unroll=unroll)
            res["mesh_name"] = mesh_name
            with open(fn, "w") as f:
                json.dump(res, f, indent=1)
            status = res["status"]
            extra = ""
            if status == "ok":
                r = res["roofline"]
                extra = (f" dominant={r['dominant']} "
                         f"frac={r['roofline_fraction']:.3f} "
                         f"counted={res['lower_s']:.1f}s")
            elif status == "error":
                extra = " " + res["error"][:200]
            print(f"         -> {status}{extra}", flush=True)
            results.append(res)
    return results
