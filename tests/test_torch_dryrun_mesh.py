"""The dry-run's count of one rank of a mesh of many
(``launch.mesh.RankMesh``, ``distributed.collectives``) held to live
gloo ranks, to the layout, to itself unrolled and to the reference's
compiled cells on a small mesh; the multi-pod mesh at full width; the
CLI; the seam.

Live ranks: spawned gloo worlds of 2 and 4 (a ``FileStore`` under the
test's temporary directory, no socket) run a train step and a prefill of
each ``ARCHS`` smoke config on every ``MESHES`` mesh, each rank under the
dry-run's ``Counter`` (``dryrun_lib.count``) with the seam recording its
collectives, and count the same cell with the stand-in at their own
coordinates (``unroll=True``); the two must be equal in FLOPs, matmul
FLOPs, bytes, argument bytes and collectives by kind and group size
(count and operand bytes).

The reference's cells compile in one subprocess an architecture and mesh
on 4 forced host devices, a ``(data, model)`` mesh with Auto axes (as
``tests/test_torch_tensor_parallel.py``'s), while the port counts its
cells here; their per-chip dot FLOPs (``hlo.analyze``) and argument
bytes are held to the port's count, for the dense, MoE (``routed_ep``),
MLA with MTP and Mamba2 families: equal, or off by the gaps that
``_train_gap``, ``_mla_gap`` and ``_conv_tail_gap`` state (and, in an
MLA train step, a residual within ``_mla_train_bound``). The dense
smoke's 2 KV heads over a model axis of 4 run the reference's
context-parallel attention (each rank its column blocks of the leaves
and its rows of the queries, its rows of the decode caches' sequence):
equal. The reference's collectives are not compared: its
partitioner picks them (their kinds, counts and operands) where the
port's layout names them (``PERF.md`` §7).
"""
import dataclasses
import glob
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import tree
from repro_torch.bench.views import roofline
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import data_parallel
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import dryrun, dryrun_lib
from repro_torch.launch.mesh import Mesh, RankMesh, make_production_mesh
from repro_torch.models import model
from repro_torch.models.layers import ShapesOnly
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_step import make_train_state_shapes

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = "qwen2-7b-smoke"
ARCHS = (SMOKE, "deepseek-moe-16b-smoke", "deepseek-v3-671b-smoke",
         "mamba2-370m-smoke")
#: (pod, data, model); pod 1 is a ("data", "model") mesh; on (1, 1, 4)
#: the GQA blocks' 2 KV heads do not divide: context-parallel
MESHES = ((1, 1, 2), (1, 2, 1), (1, 2, 2), (2, 1, 2), (1, 1, 4))
LIVE_SHAPES = (ShapeConfig("train_32", "train", 32, 4),
               ShapeConfig("prefill_32", "prefill", 32, 4))
#: the MoE configs' capacity factor in the live cells: nothing drops
CAPACITY = 8.0
RANKS_TIMEOUT_S = 300
#: the keys a live rank's count and the stand-in's must agree on, beside
#: the collectives
COUNTED = ("flops", "matmul_flops", "bytes", "argument_bytes")


def _sizes(pod, data, model_):
    return (pod, data, model_) if pod > 1 else (data, model_)


RANK = """
import json, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                        rank=rank, world_size=world)
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import set_device
from repro_torch.distributed.sharding import make_context
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.models import convert, model
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_step import data_shard, make_train_state
set_device("cpu")
meshes, archs, shapes, capacity = (json.loads(a) for a in sys.argv[5:9])
out = {}
for pod, data, model_ in meshes:
    if pod * data * model_ != world:
        continue
    mesh = make_host_mesh(data, model_, pod=pod)
    names = tuple(mesh.mesh_dim_names)
    coords = tuple(mesh.get_local_rank(a) for a in names)
    stand = RankMesh(names, tuple(mesh.shape), coords, one_rank_groups=True)
    for arch in archs:
        cfg = get_config(arch)
        over = {"capacity_factor": capacity} if cfg.num_experts else {}
        for name, kind, seq, batch in shapes:
            shape = ShapeConfig(name, kind, seq, batch)
            ctx = make_context(mesh, remat="full", **over)
            fn, _ = dryrun_lib._build(cfg, shape, ctx)
            gen = torch.Generator().manual_seed(0)
            keep = convert.local_tp_keep(cfg, ctx)
            tokens = torch.randint(0, cfg.vocab_size, (
                batch, seq + (kind == "train")), generator=torch.Generator(
                ).manual_seed(1), dtype=torch.int32)
            tokens = data_shard({"tokens": tokens}, ctx)["tokens"]
            if kind == "train":
                state = make_train_state(gen, cfg, OptimizerConfig(),
                                         keep=keep)
                args = (state, {"tokens": tokens})
            else:
                args = (model.init(gen, cfg, keep=keep), tokens)
            live = dryrun_lib.count(fn, args)
            counted = dryrun_lib.count_cell(
                cfg, shape, make_context(stand, remat="full", **over),
                unroll=True)
            out[f"{pod}x{data}x{model_}|{arch}|{name}|{rank}"] = {
                "coords": coords, "live": live, "stand": counted}
with open(sys.argv[4], "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


REFERENCE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
from repro.launch import dryrun_lib as jdry
from repro_torch.common import hlo
keep = hlo._op_flops
# the dot FLOPs only, trip counts included (tests/test_torch_dryrun.py)
hlo._op_flops = lambda op, tbl: (hlo._dot_flops(op, tbl)
                                 if op.opcode == "dot" else 0.0)
out = {}
for arch, shape, D, M in json.loads(sys.argv[1]):
    mesh = jax.make_mesh((D, M), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn, args = jdry.build_cell(arch, shape, mesh,
                               ctx_overrides={"remat": "full"})
    compiled = fn.lower(*args).compile()
    got = hlo.analyze(compiled.as_text(), D * M)
    out[f"{arch}|{shape}|{D}x{M}"] = (
        got["flops_per_chip"],
        compiled.memory_analysis().argument_size_in_bytes,
        {k: v["count"] for k, v in got["by_kind"].items()})
print(json.dumps(out))
"""
REF_SHAPES = ("prefill_32k", "decode_32k", "train_4k")
#: the reference's cells: (arch, shape, data, model); the dense smoke at
#: heads that divide (2 x 2) and that do not (1 x 4), every other family
#: of ``ARCHS`` at 2 x 2
REF_CELLS = [(SMOKE, s, D, M) for s in REF_SHAPES
             for D, M in ((2, 2), (1, 4))] + \
    [(arch, s, 2, 2) for arch in ARCHS[1:] for s in REF_SHAPES]
#: a decode cell of batch 1, whose caches the reference cuts on the
#: sequence over the data axes (``cache_specs``), as the port does
BATCH1_CELLS = [("gemma3-4b-smoke", "long_500k", 2, 2)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The live ranks' records by ``mesh|arch|shape|rank``; each of
    ``REF_CELLS``, the port's record of the rank at the origin and the
    reference's compiled cell (dot FLOPs a device, argument bytes, its
    collectives' count by kind). The
    ranks and the reference (one subprocess an architecture and mesh)
    start at once; the port counts its cells here while they run."""
    tmp = tmp_path_factory.mktemp("dryrun_mesh")
    env = _env()
    shapes = json.dumps([[s.name, s.kind, s.seq_len, s.global_batch]
                         for s in LIVE_SHAPES])
    procs, outs = [], []
    for world in (2, 4):
        for rank in range(world):
            outs.append(tmp / f"rank{world}_{rank}.json")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, str(rank), str(world),
                 str(tmp / f"store{world}"), str(outs[-1]),
                 json.dumps(MESHES), json.dumps(ARCHS), shapes,
                 json.dumps(CAPACITY)], env=env, cwd=tmp,
                stderr=subprocess.PIPE, text=True))
    cells = REF_CELLS + BATCH1_CELLS
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(
        [c for c in cells if (c[0], c[2:]) == group])], env=env,
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for group in dict.fromkeys((c[0], c[2:]) for c in cells)]
    try:
        port = {(arch, shape, D, M): dryrun_lib.run_cell(
            arch, shape, mesh=Mesh(("data", "model"), (D, M)))
            for arch, shape, D, M in cells}
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
        ref_outs = [r.communicate(timeout=RANKS_TIMEOUT_S) for r in refs]
    finally:
        for p in procs + refs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    ref = {}
    for r, (out, err) in zip(refs, ref_outs):
        assert r.returncode == 0, err[-3000:]
        ref.update(json.loads(out.strip().splitlines()[-1]))
    live = {}
    for o in outs:
        live.update(json.loads(o.read_text()))
    return live, {c: (port[c], ref["{}|{}|{}x{}".format(*c)])
                  for c in cells}


def _collectives(counts):
    return {k: v for k, v in counts.items() if k.startswith("collective")}


# ------------------------------------------ the stand-in against live ranks
@pytest.mark.parametrize("shape", [s.name for s in LIVE_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_the_stand_in_counts_what_a_live_rank_runs(worlds, mesh, arch,
                                                   shape):
    """Every rank of the mesh: the stand-in's count at the rank's
    coordinates equals the rank's own count of its live run, FLOPs,
    bytes, argument bytes and every collective it called."""
    live, _ = worlds
    pod, data, model_ = mesh
    n = pod * data * model_
    tag = f"{pod}x{data}x{model_}|{arch}|{shape}"
    recs = [live[f"{tag}|{r}"] for r in range(n)]
    assert sorted(tuple(r["coords"]) for r in recs) == sorted(
        tuple(c) for c in _all_coords(_sizes(pod, data, model_)))
    for r in recs:
        have, want = r["stand"], r["live"]
        assert {k: have[k] for k in COUNTED} == \
            {k: want[k] for k in COUNTED}, r["coords"]
        assert _collectives(have) == _collectives(want), r["coords"]
    # the mesh's collectives are there: any axis of more than one rank
    # moves something in a train step
    if shape.startswith("train"):
        assert all(_collectives(r["live"]) for r in recs)


def _all_coords(sizes):
    if not sizes:
        return [()]
    return [(i,) + rest for i in range(sizes[0])
            for rest in _all_coords(sizes[1:])]


# ---------------------------------------------------------- argument bytes
def _layout_bytes(cfg, ctx, leaves):
    """The bytes of ``leaves`` (name -> whole tensor of a parameter tree,
    or of a state holding parameter-shaped trees) on the rank of ``ctx``:
    each cut leaf over the ranks of each axis that cuts it."""
    cuts = TP.cuts_of(leaves, TP.layout(cfg, ctx))
    M, D = ctx.tp_size, TP.data_ways(ctx)
    total = 0
    for name, t in leaves.items():
        n = t.numel() * t.element_size()
        c = cuts.get(name)
        if c is not None:
            n //= (M if c.model is not None else 1) * \
                (D if c.data is not None else 1)
        total += n
    return total


@pytest.mark.parametrize("sizes, coords", [
    ((2, 2), (1, 0)), ((4, 2), (3, 1)), ((2, 4, 8), (1, 3, 5))],
    ids=["2x2", "4x2", "2x4x8"])
@pytest.mark.parametrize("arch", ARCHS + ("llama-3.2-vision-90b-smoke",
                                          "zamba2-2.7b-smoke"))
def test_argument_bytes_are_the_layouts_count(arch, sizes, coords):
    """A rank's train-cell arguments are its block of the state (the
    parameters, both moments and the step) and its rows of the batch; its
    decode-cell arguments its block of the parameters, its caches (by the
    port's heads), its rows of the token and the position."""
    cfg = get_config(arch)
    names = ("pod", "data", "model")[-len(sizes):]
    ctx = sharding.make_context(RankMesh(names, sizes, coords),
                                remat="full")
    state = tree.flatten_with_names(make_train_state_shapes(
        cfg, OptimizerConfig()))
    shape = ShapeConfig("train_64", "train", 64, 64)
    B = dryrun_lib.local_rows(shape.global_batch, ctx)
    assert B == 64 // ctx.data_axes_size
    images = B * cfg.num_image_tokens * cfg.d_model * 2 \
        if cfg.cross_attn_every else 0
    fn, args = dryrun_lib._build(cfg, shape, ctx)
    got = dryrun_lib.count(lambda *a: None, args)["argument_bytes"]
    assert got == _layout_bytes(cfg, ctx, state) + B * 65 * 4 + images
    shape = ShapeConfig("decode_64", "decode", 64, 8)
    B = dryrun_lib.local_rows(8, ctx)
    fn, args = dryrun_lib._build(cfg, shape, ctx)
    caches = model.init_cache(cfg, B, 64, device=torch.device("meta"),
                              ctx=ctx)
    params = tree.flatten_with_names(model.init(ShapesOnly(), cfg))
    images = B * cfg.num_image_tokens * cfg.d_model * 2 \
        if cfg.cross_attn_every else 0
    got = dryrun_lib.count(lambda *a: None, args)["argument_bytes"]
    assert got == _layout_bytes(cfg, ctx, params) + sum(
        t.numel() * t.element_size() for t in tree.leaves(caches)) + \
        B * 4 + 4 + images


# ------------------------------------------------------ depth by repeat
@pytest.mark.parametrize("arch, layers", [(SMOKE, 5),
                                          ("deepseek-moe-16b-smoke", 5)])
@pytest.mark.parametrize("shape", [ShapeConfig("train_64", "train", 64, 8),
                                   ShapeConfig("prefill_256", "prefill",
                                               256, 8),
                                   ShapeConfig("decode_256", "decode", 256,
                                               8)], ids=lambda s: s.name)
def test_depth_by_repeat_on_a_mesh_equals_the_unrolled_count(arch, layers,
                                                            shape):
    """One stage (the dense smoke at 5 layers) and two (the MoE smoke's
    dense layer and 4 MoE layers), at rank (1, 0, 1) of a 2 x 2 x 2 mesh:
    extrapolated from the depth points, every sum equals the count of
    every layer, each collective kind and group size included."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    ctx = sharding.make_context(RankMesh(("pod", "data", "model"),
                                         (2, 2, 2), (1, 0, 1)),
                                remat="full")
    whole = dryrun_lib.count_cell(cfg, shape, ctx, unroll=True,
                                  replay=False)
    by_repeat = dryrun_lib.count_cell(cfg, shape, ctx)
    assert by_repeat == whole
    assert _collectives(whole)


# ------------------------------------------- the reference's compiled cells
def _train_gap(cfg, shape, D: int, M: int) -> int:
    """The matmul FLOPs a train step of the reference has beyond the
    port's (``tests/test_torch_dryrun.py``'s ``_train_gap``): its remat
    keeps each attention layer's QK^T and PV once more (MLA's at its
    query-key and value head dims), and XLA emits each Mamba2 layer's two
    chunk-decay gradients as dots; on a device of a D x M mesh whose heads
    divide, 1/(D·M) of the whole step's."""
    B, S = shape.global_batch, shape.seq_len
    specs = [spec for st in cfg.plan() for _ in range(st.repeat)
             for spec in st.layers]
    n_mamba = sum(spec.kind == "mamba" for spec in specs)
    dk, dv = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
              cfg.v_head_dim) if cfg.use_mla else (cfg.head_dim,) * 2
    attn = 2 * B * cfg.num_heads * S * S * (dk + dv)
    decays = 2 * (2 * B * S * cfg.ssm_heads * cfg.ssm_head_dim)
    return ((len(specs) - n_mamba) * attn + n_mamba * decays) // (D * M)


def _mtp_bytes(cfg, D: int, M: int) -> int:
    """The bytes of a rank's block of the MTP block's leaves."""
    ctx = sharding.make_context({"data": D, "model": M})
    params = tree.flatten_with_names(model.init(ShapesOnly(), cfg))
    return _layout_bytes(cfg, ctx, {n: t for n, t in params.items()
                                    if n.startswith("mtp/")})


def _mla_gap(cfg, shape, D: int, M: int):
    """(matmul FLOPs, argument bytes) that the port's rank has beyond the
    reference's device in an MLA prefill or decode step. The reference's
    partitioner splits the latent down-projections over the model axis:
    ``wq_a`` and ``wkv_a`` by tokens in a prefill, ``wkv_a``'s output
    columns in a decode step; the port computes them whole on every model
    rank (their leaves enter the axis through ``TP.share``), 2·T·d·(q_lora
    + kv_lora + rope) and 2·B·d·(kv_lora + rope) a layer over the rank's
    rows, (1 - 1/M) of them more. A decode step's latent cache ``(c_kv,
    k_pe)`` is cut as the reference cuts it, its last dimension M ways
    (``layers.latent_ways``; until PR 36 it was whole, 335,544,320 B more
    in V3's decode cell at 2 x 2). ``jax.jit`` drops the arguments a cell
    does not read: a prefill or decode step reads no MTP leaf, which the
    port's arguments hold."""
    B, S, L = shape.global_batch // D, shape.seq_len, cfg.num_layers
    d, lat = cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim
    nbytes = _mtp_bytes(cfg, D, M)
    if shape.kind == "decode":
        flops = L * 2 * B * d * lat * (M - 1) // M
    else:
        flops = L * 2 * B * S * d * (cfg.q_lora_rank + lat) * (M - 1) // M
    return flops, nbytes


def _mla_train_bound(cfg, shape, D: int, M: int) -> int:
    """What the port's MLA train step may compute beyond the reference's
    device once ``_train_gap`` is taken off: the reference's partitioner
    reshards the latent down-projections and the MTP block over the model
    axis in its own way in each pass (some by tokens, some whole), so
    there is no closed form; at most (1 - 1/M) of those ops in the
    step's four passes (the forward, the remat recompute and the
    backward's two): every layer's latent projections, 2·T·d·(q_lora +
    kv_lora + rope), and the MTP block's vocabulary projection over its
    S - 1 positions, 2·T'·d·V."""
    B, S, L = shape.global_batch // D, shape.seq_len, cfg.num_layers
    d = cfg.d_model
    latent = L * 2 * B * S * d * (cfg.q_lora_rank + cfg.kv_lora_rank +
                                  cfg.qk_rope_head_dim)
    head = 2 * B * (S - 1) * d * cfg.padded_vocab_size
    return 4 * (latent + head) * (M - 1) // M


def _conv_tail_gap(cfg, shape, D: int, M: int):
    """(matmul FLOPs, argument bytes) that the port's rank has beyond the
    reference's device in a Mamba2 decode step. The port's conv runs the
    rank's d_inner/M ``x`` channels and all 2·g·N of ``B`` and ``C``, the
    reference 1/M of the contiguous ``x | B | C`` channels (ROADMAP §3):
    2·g·N·(1 - 1/M) channels more a layer, in the step's conv (a dot of
    K taps over the rank's rows) and in its conv tail cache (K - 1
    positions, bf16). XLA drops the step's unused ``pos`` from its
    arguments (``tests/test_torch_dryrun.py``): 4 bytes more."""
    B, L, K = shape.global_batch // D, cfg.num_layers, cfg.ssm_conv
    ch = 2 * cfg.ssm_ngroups * cfg.ssm_state * (M - 1) // M
    return L * 2 * B * K * ch, L * B * (K - 1) * ch * 2 + 4


def _batch1_state_gap(cfg, D: int, M: int) -> int:
    """The argument bytes that a rank of a D x M data x model mesh holds
    beyond the reference's device in a decode cell of batch 1: the
    reference's ``cache_specs`` cuts a Mamba2 layer's float32 state
    ``[1, h, p, N]`` on its heads over the data axes (dimension 2 of its
    stacked leaf) and on ``p`` over ``model``; the port keeps the heads
    whole over the data axes and cuts them over ``model`` (``[1, h/M, p,
    N]`` a rank): (1 - 1/D) of the rank's state more. The attention
    caches are cut alike (``layers.ContextSplit``); the conv tail is
    ``_conv_tail_gap``'s."""
    n = sum(s.kind == "mamba" for s in model.layer_specs(cfg))
    state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 // M
    return n * state * (D - 1) // D


def test_the_gaps_are_the_stated_numbers():
    cfg = get_config(SMOKE)
    assert _train_gap(cfg, SHAPES["train_4k"], 2, 2) == 1_099_511_627_776
    assert _train_gap(get_config("deepseek-moe-16b-smoke"),
                      SHAPES["train_4k"], 2, 2) == 1_099_511_627_776
    v3 = get_config("deepseek-v3-671b-smoke")
    assert _train_gap(v3, SHAPES["train_4k"], 2, 2) == 1_374_389_534_720
    assert _mtp_bytes(v3, 2, 2) == 27_136
    assert _mla_gap(v3, SHAPES["prefill_32k"], 2, 2) == \
        (9_663_676_416, 27_136)
    assert _mla_gap(v3, SHAPES["decode_32k"], 2, 2) == (655_360, 27_136)
    # what a batch-1 rank of the multi-pod mesh still holds beyond the
    # reference's device: the Mamba2 state's heads, whole over the 32
    # data ranks where the reference cuts them (ROADMAP §3)
    assert _batch1_state_gap(get_config("mamba2-370m"), 32, 16) == \
        3_047_424
    assert _batch1_state_gap(get_config("zamba2-2.7b"), 32, 16) == \
        4_285_440
    assert _batch1_state_gap(get_config("gemma3-4b"), 32, 16) == 0
    assert _mla_train_bound(v3, SHAPES["train_4k"], 2, 2) == \
        73_006_055_424
    mamba = get_config("mamba2-370m-smoke")
    assert _train_gap(mamba, SHAPES["train_4k"], 2, 2) == 2 ** 29
    assert _conv_tail_gap(mamba, SHAPES["decode_32k"], 2, 2) == \
        (32_768, 24_580)
    # the dense smoke's 2 KV heads over 4 ranks: context-parallel, every
    # attention leaf cut, and the train step's gap the only one left
    # (whole blocks on every model rank cost 2.6e13, 3.2e9 and 1.2e13
    # matmul FLOPs a rank more in the prefill, decode and train cells)
    ctx = sharding.make_context({"data": 1, "model": 4})
    plan = TP.plan(cfg, ctx)
    assert (plan.attn, plan.cp) == (False, True)
    assert sum("/attn/" in n for n in TP.layout(cfg, ctx)) == \
        7 * cfg.num_layers
    assert _train_gap(cfg, SHAPES["train_4k"], 1, 4) == 1_099_511_627_776


def _cell_id(c):
    return (f"{c[1]}-" if c[0] == SMOKE else f"{c[0]}-{c[1]}-") + \
        f"{c[2]}x{c[3]}"


@pytest.mark.parametrize("cell", REF_CELLS, ids=_cell_id)
def test_the_count_against_the_references_compiled_cell(worlds, cell):
    """The rank at the origin against the reference's device 0, dot FLOPs
    and argument bytes. GQA heads that divide over the model axis (4/2
    over 2) and that do not (over 4, context-parallel): equal, but for
    the train step's ``_train_gap``. ``routed_ep``'s MoE: as the
    dense. MLA with MTP: off by ``_mla_gap`` in a prefill or decode step;
    its train step's arguments equal, its FLOPs those of the reference
    less ``_train_gap``, plus at most ``_mla_train_bound``. Mamba2: equal
    but for ``_train_gap`` and a decode step's ``_conv_tail_gap``."""
    arch, shape, D, M = cell
    cfg, sh = get_config(arch), SHAPES[shape]
    rec, (ref_flops, ref_args, _) = worlds[1][cell]
    assert rec["status"] == "ok", rec.get("error")
    flops, nbytes = rec["cost"]["matmul_flops_per_chip"], \
        rec["memory"]["argument_bytes"]
    bound = 0
    if cfg.use_mla:
        if sh.kind == "train":
            gap, nbytes_gap = -_train_gap(cfg, sh, D, M), 0
            bound = _mla_train_bound(cfg, sh, D, M)
        else:
            gap, nbytes_gap = _mla_gap(cfg, sh, D, M)
    elif cfg.family == "ssm":
        gap, nbytes_gap = _conv_tail_gap(cfg, sh, D, M) \
            if sh.kind == "decode" else (0, 0)
        if sh.kind == "train":
            gap = -_train_gap(cfg, sh, D, M)
    else:
        gap, nbytes_gap = (-_train_gap(cfg, sh, D, M)
                           if sh.kind == "train" else 0), 0
    assert 0 <= flops - gap - ref_flops <= bound
    assert nbytes - nbytes_gap == ref_args


@pytest.mark.parametrize("cell", BATCH1_CELLS, ids=_cell_id)
def test_a_batch_1_cells_arguments_are_the_references(worlds, cell):
    """A decode cell of batch 1 on 2 x 2: the rank at the origin's
    argument bytes equal the reference's device 0's. Its caches are cut
    on the sequence over the data axis (``layers.ContextSplit``) and on
    the KV heads over the model axis, as the reference's
    ``cache_specs`` cuts them; the token and the position are whole on
    every rank. ``gemma3-4b-smoke`` has no Mamba2 state, which the port
    keeps whole over the data axes (``_batch1_state_gap``)."""
    arch, shape, D, M = cell
    cfg = get_config(arch)
    assert SHAPES[shape].global_batch % D and not (
        cfg.num_heads % M or cfg.num_kv_heads % M)
    rec, (_, ref_args, _) = worlds[1][cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_bytes"] == ref_args


def test_the_references_collectives_are_its_partitioners(worlds):
    """Why the collectives are not compared: the reference's partitioner
    picks its own. It calls no reduce-scatter in the MoE smoke's train
    step, where the port reduce-scatters each FSDP gradient block, and
    collective-permutes in every Mamba2 cell, which the port never
    calls; the port's kinds are the four of the seam."""
    cells = worlds[1]
    moe = ("deepseek-moe-16b-smoke", "train_4k", 2, 2)
    rec, (_, _, kinds) = cells[moe]
    assert "reduce-scatter" not in kinds
    assert rec["collectives"]["by_kind"]["reduce-scatter"]["count"] > 0
    for shape in REF_SHAPES:
        rec, (_, _, kinds) = cells["mamba2-370m-smoke", shape, 2, 2]
        assert kinds["collective-permute"] > 0
        assert set(rec["collectives"]["by_kind"]) <= \
            set(collectives.KINDS)


# -------------------------------------------------- the multi-pod mesh
def test_a_full_width_multi_pod_cell():
    """``qwen2-7b`` x ``decode_32k`` on the 2 x 16 x 16 mesh: 4 rows a
    rank, its FFN, vocabulary and attention leaves 1/16 (its 4 KV heads
    do not divide over 16: context-parallel), every FSDP leaf 1/16 over
    ``data``; 1/16 of its rows' KV cache, cut on the sequence."""
    rec = dryrun_lib.run_cell("qwen2-7b", "decode_32k", multi_pod=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["num_devices"] == 512
    cfg = get_config("qwen2-7b")
    ctx = sharding.make_context(make_production_mesh(multi_pod=True).shape)
    B = 128 // 32
    params = tree.flatten_with_names(model.init(ShapesOnly(), cfg))
    caches = cfg.num_layers * 2 * B * 32768 * cfg.num_kv_heads * \
        cfg.head_dim * 2 // 16
    assert TP.plan(cfg, ctx).cp
    assert rec["memory"]["argument_bytes"] == \
        _layout_bytes(cfg, ctx, params) + caches + B * 4 + 4
    assert rec["roofline"]["collective_s"] > 0
    assert rec["collectives"]["num_collectives"] > 0
    assert rec["model_flops_per_chip"] == rec["model_flops_total"] / 512
    assert rec["memory"]["fits_hbm"] is True


def test_the_cli_writes_multi_pod_records_the_view_reads(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    out = str(tmp_path / "dry")
    code = dryrun.main(["--arch", SMOKE, "--shape", "decode_32k", "--shape",
                        "long_500k", "--multi-pod-only", "--out", out])
    assert code == 0
    said = capsys.readouterr().out
    assert "dry-run: 1 ok, 1 skipped, 0 errors" in said
    assert "  multipod: 1 ok, 1 skipped, 0 errors" in said
    assert "  pod:" not in said
    names = sorted(os.path.basename(p) for p in glob.glob(out + "/*.json"))
    assert names == [f"{SMOKE}__decode_32k__multipod.json",
                     f"{SMOKE}__long_500k__multipod.json"]
    rec = json.load(open(os.path.join(out, names[0])))
    assert (rec["status"], rec["mesh"], rec["num_devices"]) == \
        ("ok", {"pod": 2, "data": 16, "model": 16}, 512)
    monkeypatch.setattr(roofline, "DRYRUN_DIR", out)
    monkeypatch.chdir(tmp_path)
    rows = roofline.run()
    assert rows[0] == ("roofline.matrix", 0.0,
                       "pod ok=0 skipped=0 err=0; multipod ok=1")


# ---------------------------------------------------------------- the seam
def test_a_counted_group_never_reaches_torch_distributed(monkeypatch):
    """Over the stand-in's groups nothing is sent: every
    ``torch.distributed`` call raises here, and a train step on a 2 x 2
    x 2 mesh still counts every kind it calls."""
    def refuse(*a, **k):
        raise AssertionError("a counted group reached torch.distributed")
    for name in ("all_reduce", "all_gather", "reduce_scatter",
                 "all_to_all_single", "get_world_size"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    ctx = sharding.make_context({"pod": 2, "data": 2, "model": 2},
                                remat="full")
    c = dryrun_lib.count_cell(get_config("deepseek-moe-16b-smoke"),
                              ShapeConfig("train_64", "train", 64, 8), ctx)
    kinds = {k.split(" ")[1] for k in _collectives(c)}
    assert kinds == {"all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all"}
    assert dryrun_lib.collectives_of(c)["num_collectives"] == sum(
        v for k, v in c.items() if k.endswith(" count"))


def test_the_seam_makes_each_result_locally():
    """Over a counted group, on ``meta`` tensors: an all-reduce returns the
    tensor it was given, a gather ``ways`` blocks joined, a
    reduce-scatter one block, an all-to-all leaves its output; each call
    is tallied with the reference's operand bytes and ring factors. A
    tensor that holds values is refused: its result would not be the
    collective's."""
    g = collectives.CountedGroup("model", 4)
    t = torch.zeros(2, 8, device="meta")
    with collectives.recording() as tally:
        assert collectives.all_reduce(t, g) is t
        assert collectives.all_gather(t, g, 1).shape == (2, 32)
        assert collectives.reduce_scatter(t, g, 1).shape == (2, 2)
        out = torch.empty(2, 8, device="meta")
        assert collectives.all_to_all_single(out, t, g) is None
        assert out.shape == (2, 8)
        assert collectives.world_size(g) == 4
    assert tally.calls == {(k, 4): [1, 64] for k in collectives.KINDS}
    cpu = torch.zeros(2, 8)
    for call in (lambda: collectives.all_reduce(cpu, g),
                 lambda: collectives.all_gather(cpu, g, 1),
                 lambda: collectives.reduce_scatter(cpu, g, 1),
                 lambda: collectives.all_to_all_single(
                     torch.empty_like(cpu), cpu, g)):
        with pytest.raises(ValueError, match="takes meta tensors"):
            call()
    s = collectives.summarize(tally.calls)
    assert s["num_collectives"] == 4 and s["total_operand_bytes"] == 256
    assert s["by_kind"]["all-gather"]["traffic_bytes"] == 64 * 3
    assert s["by_kind"]["all-reduce"]["traffic_bytes"] == 64 * 2 * 3 / 4
    assert s["by_kind"]["reduce-scatter"]["traffic_bytes"] == 64 * 3 / 4
    assert s["total_traffic_bytes"] == 64 * (3 + 1.5 + 0.75 + 0.75)


def test_the_stand_in_of_a_live_rank_has_groups_of_one():
    """A live ``DeviceMesh`` has a process group on an axis of one rank,
    over which ``routed_ep`` exchanges and takes its mean; the stand-in of
    a live rank (``one_rank_groups``) counts them, the dry-run's (the pod
    record's one card) has no group there."""
    live_like = RankMesh(("data", "model"), (2, 1), (1, 0),
                         one_rank_groups=True)
    assert live_like.get_group("model") == collectives.CountedGroup(
        "model", 1)
    assert live_like.get_group("data") == collectives.CountedGroup("data", 2)
    assert RankMesh(("data", "model"), (2, 1)).get_group("model") is None
    ctx = sharding.make_context(live_like, remat="full")
    c = dryrun_lib.count_cell(get_config("deepseek-moe-16b-smoke"),
                              ShapeConfig("train_64", "train", 64, 8), ctx)
    assert c["collective all-to-all 1 count"] > 0
    assert c["collective all-reduce 1 count"] > 0


def test_a_strided_tensor_is_summed_in_place(monkeypatch):
    """``data_parallel``'s sums are in place: where the seam reduced a
    contiguous copy of a strided tensor, the sum is written back into the
    tensor given (a gradient, the metrics)."""
    def twice(t, group, op=None):
        return t.contiguous() * 2       # the sum over two equal ranks
    monkeypatch.setattr(data_parallel.C, "all_reduce", twice)
    g = torch.arange(6.0).reshape(2, 3).t()
    assert not g.is_contiguous()
    assert data_parallel._sum(g, ["data", "pod"]) is g
    assert torch.equal(g, torch.arange(6.0).reshape(2, 3).t() * 4)

