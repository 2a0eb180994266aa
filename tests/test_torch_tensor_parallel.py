"""Tensor parallelism over the model axis (``distributed.tensor_parallel``,
``sharding.split_dim``, ``convert.local_tp_params``) and FSDP over the
data axis (``distributed.fsdp``, ``sharding.fsdp_dim``) against the
reference's partition rules at work, on the CPU.

The reference runs in three subprocesses on 4 forced host devices each
(the shard shapes, serving and the launcher's steps; each half of the
training steps), its calls jitted
with ``in_shardings`` from its ``param_specs`` over a ``(data,
model)`` mesh with Auto axes: what each device holds (its
``NamedSharding.shard_shape``), prefill logits and greedy decode ids,
one training step, and the launcher's steps. The port runs as spawned
gloo ranks (a ``FileStore`` under the test's temporary directory, no
socket), each rank holding its block of every cut leaf (its share of
each split leaf and, on a data axis of more than one rank, its FSDP
block); rank ``(d, m)`` is held to the reference's rows of data shard
``d``, and for some cases its own blocks to the reference device's
shards at ``(d, m)``. Inputs come from numpy seeds; the reference's
parameters and states reach the port through ``models.convert``.

Configs: ``qwen2-7b-smoke`` (4 heads over 2 KV heads: split at M 2,
context-parallel at M 4 as the reference partitions it: every attention
leaf cut, the q rows split over the ranks, ``dense-1x4`` and
``dense-1x4-seq``), an
8-head/4-KV variant of it (split at M 4), ``deepseek-moe-16b-smoke``
(attention and shared experts split, experts through ``routed_ep``),
``deepseek-v3-671b-smoke`` (MLA and MTP) and ``mamba2-370m-smoke`` on a
data axis, and the full ``qwen2-7b`` and ``deepseek-moe-16b`` on
``meta`` tensors for the shard shapes. The families whose leaves the
model axis splits since the MLA, Mamba2, cross-attention and MTP split
(``FAMILIES``: ``deepseek-v3-671b-smoke``, ``mamba2-370m-smoke``,
``zamba2-2.7b-smoke``, ``llama-3.2-vision-90b-smoke``, each at the
8-head/4-KV width on a model axis of 4) serve and take a step on (1, 2),
(2, 2) and (1, 4), with and without ``seq_shard_residual``, their norms,
gates and SSM leaves opened by seeded noise; ``gemma3-4b-smoke`` takes a
step under the hint; the full configs of those four families are held
to the reference's shard shapes at M 2 and 4.

Tolerances: float32 logits within 1e-5 of the largest |logit| and ids
equal; bf16 logits within 0.05; a training step's loss, ce and
grad_norm within 1e-5 relative and every leaf within 1e-5 of its
largest |value| but for 0.1% of a tree's elements (``FLIP_BUDGET``:
the sign of a first step on a near-zero gradient,
``tests/test_torch_moe_ep_train.py``'s budget), and for the family
cases every first-moment element within 1e-4 of its leaf's largest
|value| (``MU_TOL``, no budget); the launcher's bf16 losses and leaves
within 5e-2.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import tree
from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import convert, layers as L, model
from repro_torch.models.layers import ModelContext, ShapesOnly
from repro_torch.train import OptimizerConfig
from repro_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSE, MOE = "qwen2-7b-smoke", "deepseek-moe-16b-smoke"
MLA, SSM = "deepseek-v3-671b-smoke", "mamba2-370m-smoke"
#: the 8-head/4-KV variant of DENSE, whose heads divide over 4 ranks
WIDE = {"num_heads": 8, "num_kv_heads": 4}
#: the families that split MLA, Mamba2, cross-attention and the MTP layer
#: over the model axis, by a short tag
FAMILIES = {"v3": MLA, "mamba": SSM, "zamba": "zamba2-2.7b-smoke",
            "vlm": "llama-3.2-vision-90b-smoke"}
TOL32, TOL_BF16, FLIP_BUDGET = 1e-5, 5e-2, 1e-3
#: a first moment's bound, leaf by leaf and element by element
MU_TOL = 1e-4
CHUNK, LR = 8, 1e-3
SEQ = {"seq_shard_residual": True}
NO_TP = {"no_tp": True}
#: serving: (arch, config overrides, data, model, context hints, dtype)
SERVE = {
    "dense-1x2": (DENSE, {}, 1, 2, {}, "float32"),
    "dense-2x2": (DENSE, {}, 2, 2, {}, "float32"),
    "dense-1x4": (DENSE, {}, 1, 4, {}, "float32"),
    "wide-1x4": (DENSE, WIDE, 1, 4, {}, "float32"),
    "dense-1x2-bf16": (DENSE, {}, 1, 2, {}, "bfloat16"),
    "moe-1x2": (MOE, {}, 1, 2, {}, "float32"),
    "moe-2x2": (MOE, {}, 2, 2, {}, "float32"),
    "dense-1x2-seq": (DENSE, {}, 1, 2, SEQ, "float32"),
    "moe-2x2-seq": (MOE, {}, 2, 2, SEQ, "float32"),
    "dense-2x2-notp": (DENSE, {}, 2, 2, NO_TP, "float32"),
}
for _f, _a in FAMILIES.items():
    SERVE.update({
        f"{_f}-1x2": (_a, {}, 1, 2, {}, "float32"),
        f"{_f}-2x2": (_a, {}, 2, 2, {}, "float32"),
        f"{_f}-1x4": (_a, WIDE, 1, 4, {}, "float32"),
        f"{_f}-1x2-bf16": (_a, {}, 1, 2, {}, "bfloat16"),
        f"{_f}-1x2-seq": (_a, {}, 1, 2, SEQ, "float32")})
SERVE_B, PROMPT, NEW = 4, 16, 3
#: one float32 training step: (arch, config overrides, data, model,
#: context hints, step kwargs)
TRAIN = {
    "dense-1x2": (DENSE, {}, 1, 2, {}, {}),
    "dense-2x2": (DENSE, {}, 2, 2, {}, {}),
    "wide-1x4": (DENSE, WIDE, 1, 4, {}, {}),
    "dense-1x2-compressed": (DENSE, {}, 1, 2, {}, {"grad_compression": True}),
    "dense-2x2-microbatch": (DENSE, {}, 2, 2, {}, {"microbatch": 2}),
    "dense-1x2-seq": (DENSE, {}, 1, 2, SEQ, {}),
    "dense-2x2-seq": (DENSE, {}, 2, 2, SEQ, {}),
    # KV 2 over 4: context-parallel attention on the sequence-split
    # residual
    "dense-1x4-seq": (DENSE, {}, 1, 4, SEQ, {}),
    "dense-1x2-notp": (DENSE, {}, 1, 2, NO_TP, {}),
    "dense-2x2-notp": (DENSE, {}, 2, 2, NO_TP, {}),
    # FSDP over the data axis
    "dense-2x1": (DENSE, {}, 2, 1, {}, {}),
    "dense-4x1": (DENSE, {}, 4, 1, {}, {}),
    "dense-2x2-compressed": (DENSE, {}, 2, 2, {}, {"grad_compression": True}),
    "moe-2x2": (MOE, {}, 2, 2, {}, {}),
    "mla-2x1": (MLA, {}, 2, 1, {}, {}),
    "ssm-2x1": (SSM, {}, 2, 1, {}, {}),
    # the local/global family under the hint
    "gemma-1x2-seq": ("gemma3-4b-smoke", {}, 1, 2, SEQ, {}),
}
for _f, _a in FAMILIES.items():
    for _h, _hints in (("", {}), ("-seq", SEQ)):
        TRAIN.update({
            f"{_f}-1x2{_h}": (_a, {}, 1, 2, _hints, {}),
            f"{_f}-2x2{_h}": (_a, {}, 2, 2, _hints, {}),
            f"{_f}-1x4{_h}": (_a, WIDE, 1, 4, _hints, {})})
#: the training cases whose states are opened (zero-initialised norms,
#: gates and biases and the SSM leaves moved by seeded noise)
OPENED = tuple(t for t in TRAIN if t.split("-")[0] in FAMILIES or
               t.startswith("gemma"))
#: the training cases whose ranks' blocks are held to the reference
#: devices' shards, after the conversion and after the step
SHARDS = ("dense-2x2", "dense-4x1", "moe-2x2") + tuple(
    f"{f}-{mesh}" for f in FAMILIES for mesh in ("2x2", "1x4-seq"))
STEP_B, STEP_S = 4, 16
#: the full configs whose shard shapes are held, at these model axes
FULL, FULL_M = ("qwen2-7b", "deepseek-moe-16b"), (2, 4)
#: and the full configs of FAMILIES, at the same model axes
FULL_FAMILIES = ("deepseek-v3-671b", "mamba2-370m", "zamba2-2.7b",
                 "llama-3.2-vision-90b")
#: and at these data x model meshes (FSDP)
FULL_DM = ((2, 1), (4, 1), (2, 2))
#: the launcher's runs: bf16 (the config's), 1 x 2 and 2 x 1 ranks
LAUNCH_B, LAUNCH_S, LAUNCH_STEPS = 2, 16, 4
LAUNCH_MESHES = {"mp": (1, 2), "dp": (2, 1)}
RANKS_TIMEOUT_S = 600
#: the reference processes that share the training steps
REF_TRAIN_PARTS = 4

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding import make_context, param_specs
from repro.models import model
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import tree
inputs = pickle.load(open(sys.argv[1], "rb"))
serve, train = json.loads(sys.argv[2]), json.loads(sys.argv[3])
# sys.argv[4]: "1" to record the shapes and the launcher's steps too
shapes_too = steps_too = sys.argv[4] == "1"
out = {}


def mesh_of(D, M):
    return jax.make_mesh((D, M), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def shardings(mesh, t, no_tp=False):
    return jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), param_specs(t, mesh, no_tp=no_tp),
        is_leaf=lambda x: isinstance(x, P))


for arch in (%(full)r + %(full_families)r) if shapes_too else ():
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda k: model.init(k, cfg),
                            jax.random.PRNGKey(0))
    for M in %(full_m)r:
        mesh = mesh_of(1, M)
        specs = jax.tree_util.tree_leaves(
            param_specs(shapes, mesh), is_leaf=lambda x: isinstance(x, P))
        for n, s, p in zip(tree.flatten_with_names(shapes),
                           jax.tree_util.tree_leaves(shapes), specs):
            out[f"shape|{arch}|{M}|{n}"] = np.asarray(
                NamedSharding(mesh, p).shard_shape(s.shape))
    for D, M in (%(full_dm)r if arch in %(full)r else ()):
        mesh = mesh_of(D, M)
        specs = jax.tree_util.tree_leaves(
            param_specs(shapes, mesh), is_leaf=lambda x: isinstance(x, P))
        for n, s, p in zip(tree.flatten_with_names(shapes),
                           jax.tree_util.tree_leaves(shapes), specs):
            out[f"shape|{arch}|{D}x{M}|{n}"] = np.asarray(
                NamedSharding(mesh, p).shard_shape(s.shape))

for tag, (arch, over, D, M, hints, dtype) in serve.items():
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **over)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params", tag])
    tokens = jnp.asarray(inputs["prompt"])
    # the VLM's image embeddings, rows sharded as the tokens
    img = ({"image_embeds": jnp.asarray(inputs["img", tag], cfg.dtype)}
           if ("img", tag) in inputs else {})
    mesh = mesh_of(D, M)
    ctx = make_context(mesh, remat="none", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d, **hints)
    ps = shardings(mesh, params, ctx.no_tp)
    rows = NamedSharding(mesh, P(ctx.data_axes))
    prefill = jax.jit(lambda p, t, e: model.prefill(
        p, t, cfg, ctx, cache_len=%(prompt)d + %(new)d, **e),
        in_shardings=(ps, rows, {k: rows for k in img}))
    decode = jax.jit(lambda p, c, t, pos, e: model.decode_step(
        p, c, t, pos, cfg, ctx, **e))
    if arch not in (%(dense)r, %(moe)r):
        for n, s, p in zip(tree.flatten_with_names(params),
                           jax.tree_util.tree_leaves(params),
                           jax.tree_util.tree_leaves(
                               param_specs(params, mesh),
                               is_leaf=lambda x: isinstance(x, P))):
            out[f"serve|{tag}|shard|{n}"] = np.asarray(
                NamedSharding(mesh, p).shard_shape(s.shape))
    with mesh:
        caches, logits = prefill(params, tokens, img)
        ids = [np.asarray(jnp.argmax(logits, -1))]
        out[f"serve|{tag}|logits"] = np.asarray(logits, np.float32)
        for i in range(%(new)d - 1):
            caches, logits = decode(params, caches,
                                    jnp.asarray(ids[-1][:, None]),
                                    jnp.int32(%(prompt)d + i), img)
            ids.append(np.asarray(jnp.argmax(logits, -1)))
    out[f"serve|{tag}|ids"] = np.stack(ids, 1)


def record(tag, state, metrics):
    for k in ("params", "mu", "nu", "err"):
        t = state["opt"][k] if k in ("mu", "nu") else state.get(k)
        if t is not None:
            for n, a in tree.flatten_with_names(t).items():
                out[f"{tag}|{k}|{n}"] = np.asarray(a, np.float32)
    for k, v in metrics.items():
        out[f"{tag}|metric|{k}"] = np.asarray(v, np.float32)


def shards(tag, when, mesh, state, ss):
    # each device's shard of params, mu and nu, by its mesh position
    placed = jax.device_put(state, ss)
    trees = {"params": placed["params"], "mu": placed["opt"]["mu"],
             "nu": placed["opt"]["nu"]}
    D, M = mesh.devices.shape
    for k, t in trees.items():
        for n, a in tree.flatten_with_names(t).items():
            by_dev = {sh.device: sh.data for sh in a.addressable_shards}
            for d in range(D):
                for m in range(M):
                    out[f"shard|{tag}|{when}|{k}|{d}{m}|{n}"] = np.asarray(
                        by_dev[mesh.devices[d, m]], np.float32)


def step_fn(cfg, D, M, hints, kw, state):
    mesh = mesh_of(D, M)
    ctx = make_context(mesh, remat="full", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d, **hints)
    ps = shardings(mesh, state["params"], ctx.no_tp)
    ss = {"params": ps, "opt": {"mu": ps, "nu": ps},
          "step": NamedSharding(mesh, P())}
    if kw.get("grad_compression"):
        ss["err"] = ps
    fn = jax.jit(jts.make_train_step(
        cfg, ctx, jopt.OptimizerConfig(lr=%(lr)r, warmup_steps=10), **kw),
        in_shardings=(ss, None))
    return mesh, fn, ss


for tag, (arch, over, D, M, hints, kw) in train.items():
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
    state = inputs["state", tag]
    mesh, fn, ss = step_fn(cfg, D, M, hints, kw, state)
    batch = {"tokens": jnp.asarray(inputs["tokens"])}
    if ("timg", tag) in inputs:
        batch["image_embeds"] = jnp.asarray(inputs["timg", tag])
    with mesh:
        new, met = fn(state, batch)
    record(f"train|{tag}", new, met)
    if tag in %(shard_tags)r:
        shards(tag, "init", mesh, state, ss)
        shards(tag, "step", mesh, new, ss)

# the launcher's runs: bf16, from the port's initial state
for run, (D, M) in (%(launch_meshes)r.items() if steps_too else ()):
    cfg = get_config(%(arch)r)
    state = inputs["launch_state"]
    mesh, fn, _ = step_fn(cfg, D, M, {}, {}, state)
    rng = np.random.RandomState(1)
    with mesh:
        for i in range(%(steps)d):
            tokens = rng.randint(0, cfg.vocab_size,
                                 size=(%(lb)d, %(ls)d + 1)).astype(np.int32)
            state, met = fn(state, {"tokens": jnp.asarray(tokens)})
            out[f"launch-{run}|loss|{i + 1}"] = np.asarray(met["loss"],
                                                           np.float32)
    record(f"launch-{run}", state, {})
np.savez(sys.argv[5], **out)
""" % dict(full=FULL, full_families=FULL_FAMILIES, full_m=FULL_M,
           full_dm=FULL_DM, chunk=CHUNK, dense=DENSE, moe=MOE,
           prompt=PROMPT, new=NEW, lr=LR, arch=DENSE, steps=LAUNCH_STEPS,
           lb=LAUNCH_B, ls=LAUNCH_S, shard_tags=SHARDS,
           launch_meshes=LAUNCH_MESHES)

RANK = """
import dataclasses, json, pickle, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                        rank=rank, world_size=world)
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import set_device
from repro_torch.distributed import data_parallel
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import make_context
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, model
from repro_torch.serve import engine
from repro_torch.train import OptimizerConfig
from repro_torch.train import train_step as ts
set_device("cpu")
inputs = pickle.load(open(sys.argv[4], "rb"))
serve, train = json.loads(sys.argv[6]), json.loads(sys.argv[7])
out = {}
prompt = torch.from_numpy(inputs["prompt"].astype(np.int64))
for tag, (arch, over, D, M, hints, dtype) in serve.items():
    if D * M != world:
        continue
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **over)
    mesh = make_host_mesh(D, M)
    ctx = make_context(mesh, q_chunk=%(chunk)d, k_chunk=%(chunk)d, **hints)
    whole = convert.import_reference_params(inputs["params", tag], cfg)
    params = convert.local_tp_params(whole, cfg, ctx)
    for n, t in tree.flatten_with_names(params).items():
        out[f"serve|{tag}|shape|{n}"] = np.asarray(t.shape)
    d = ts.data_shard({"tokens": torch.arange(prompt.shape[0])}, ctx)
    rows = d["tokens"]
    img = ({"image_embeds": torch.from_numpy(inputs["img", tag])[rows].to(
        getattr(torch, dtype))} if ("img", tag) in inputs else {})
    caches, logits = model.prefill(params, prompt[rows], cfg, ctx,
                                   cache_len=%(prompt)d + %(new)d, **img)
    out[f"serve|{tag}|logits"] = logits.float().numpy()
    out[f"serve|{tag}|kv"] = np.asarray(caches[0][0].shape)
    for i, c in enumerate(caches):
        for j, t in enumerate(c):
            out[f"serve|{tag}|cache|{i}|{j}"] = np.asarray(t.shape)
    ids = engine.generate(params, prompt[rows], cfg, ctx,
                          max_new_tokens=%(new)d, **img)
    out[f"serve|{tag}|ids"] = ids.numpy()
    out[f"serve|{tag}|rows"] = rows.numpy()
for tag, (arch, over, D, M, hints, kw) in train.items():
    if D * M != world:
        continue
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
    mesh = make_host_mesh(D, M)
    ctx = make_context(mesh, remat="full", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d, **hints)
    whole = convert.import_reference_train_state(inputs["state", tag], cfg)
    state = convert.local_tp_state(whole, cfg, ctx)
    batch = {"tokens": torch.from_numpy(inputs["tokens"])}
    if ("timg", tag) in inputs:
        batch["image_embeds"] = torch.from_numpy(inputs["timg", tag])
    batch = ts.data_shard(batch, ctx, kw.get("microbatch", 0))
    new, met = ts.make_train_step(
        cfg, ctx, OptimizerConfig(lr=%(lr)r, warmup_steps=10), **kw)(
            state, batch)
    if tag in %(shard_tags)r:
        # this rank's blocks, in the reference's layout
        for when, st in (("init", state), ("step", new)):
            for k, t in (("params", st["params"]), ("mu", st["opt"]["mu"]),
                         ("nu", st["opt"]["nu"])):
                for n, a in tree.flatten_with_names(
                        convert.export_reference_params(t, cfg)).items():
                    out[f"shard|{tag}|{when}|{k}|{n}"] = a
        out[f"shard|{tag}|at"] = np.asarray(
            [mesh.get_local_rank("data"), mesh.get_local_rank("model")])
    new = data_parallel.gather_split(new, ctx, TP.layout(cfg, ctx))
    trees = {"params": new["params"], "mu": new["opt"]["mu"],
             "nu": new["opt"]["nu"]}
    if "err" in new:
        trees["err"] = new["err"]
    for k, t in trees.items():
        for n, a in tree.flatten_with_names(
                convert.export_reference_params(t, cfg)).items():
            out[f"train|{tag}|{k}|{n}"] = a
    for k, v in met.items():
        out[f"train|{tag}|metric|{k}"] = v.numpy()
np.savez(sys.argv[5], **out)
dist.destroy_process_group()
""" % dict(chunk=CHUNK, prompt=PROMPT, new=NEW, lr=LR, shard_tags=SHARDS)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _jcfg(arch, over, dtype):
    return dataclasses.replace(jget_config(arch), dtype=dtype, **over)


def _launcher(tmp, name, steps, mesh="mp"):
    """One launcher run over 2 gloo ranks (``LAUNCH_MESHES[mesh]``), its
    checkpoints under ``tmp/name``: the rank processes."""
    store = tmp / f"{name}.store"
    D, M = LAUNCH_MESHES[mesh]
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", DENSE,
         "--device", "cpu", "--data-parallel", str(D), "--model-parallel",
         str(M), "--batch",
         str(LAUNCH_B), "--seq", str(LAUNCH_S), "--steps", str(steps),
         "--ckpt-every", "2", "--ckpt", str(tmp / name), "--dist-init",
         f"file://{store}"], env=dict(_env(), RANK=str(rank),
                                      WORLD_SIZE="2"),
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]


def _wait(procs, timeout=RANKS_TIMEOUT_S):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _ in outs]


def _launch_state():
    """The launcher's initial state (``launch.train.train``'s)."""
    return ts.make_train_state(torch.Generator().manual_seed(0),
                               get_config(DENSE),
                               OptimizerConfig(lr=LR, warmup_steps=10))


def _launch_state_in_ref_layout():
    """``_launch_state`` in the reference's layout and leaf dtypes."""
    cfg, state = get_config(DENSE), _launch_state()
    jshapes = jts.make_train_state_shapes(jget_config(DENSE),
                                          jopt.OptimizerConfig())
    exported = {"params": convert.export_reference_params(state["params"],
                                                          cfg),
                "opt": {k: convert.export_reference_params(v, cfg)
                        for k, v in state["opt"].items()},
                "step": np.zeros((), np.int32)}
    return jax.tree_util.tree_map(lambda a, sd: np.asarray(
        jnp.asarray(a, sd.dtype)), exported, jshapes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything spawned, started together: the reference's subprocesses,
    the port's ranks for worlds of 2 and 4, and the launcher's runs (4
    steps; 2 steps, then resumed to 4). Returns (reference, [each rank's
    results], launcher outputs, the launcher's directory)."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.RandomState(11)
    inputs = {"prompt": rng.randint(0, 256, (SERVE_B, PROMPT)).astype(
        np.int32)}
    made = {}
    for tag, (arch, over, _, _, _, dtype) in SERVE.items():
        key = ("params", arch, json.dumps(over), dtype)
        if key not in made:
            params = jax.jit(jmodel.init, static_argnums=1)(
                jax.random.PRNGKey(1), _jcfg(arch, over, dtype))
            # open the zero-initialised norms and biases, so that the
            # layouts that read them matter
            made[key] = jax.tree_util.tree_map(
                lambda a: np.asarray(a if a.ndim > 1 else a + 0.1 *
                                     jnp.asarray(rng.randn(*a.shape),
                                                 a.dtype)), params)
        inputs["params", tag] = made[key]
    for tag, (arch, over, _, _, _, kw) in TRAIN.items():
        compress = bool(kw.get("grad_compression"))
        key = ("state", arch, json.dumps(over), compress, tag in OPENED)
        if key not in made:
            jcfg = _jcfg(arch, over, "float32")
            made[key] = jax.tree_util.tree_map(
                np.asarray, jax.jit(lambda k: jts.make_train_state(
                    k, jcfg, jopt.OptimizerConfig(),
                    grad_compression=compress))(jax.random.PRNGKey(0)))
            if tag in OPENED:
                made[key]["params"] = jax.tree_util.tree_map(
                    lambda a: a if a.ndim > 1 else (
                        a + 0.1 * rng.randn(*a.shape)).astype(a.dtype),
                    made[key]["params"])
        inputs["state", tag] = made[key]
    # the VLM's image embeddings, one draw a config and batch
    for cases, batch, name in ((SERVE, SERVE_B, "img"),
                               (TRAIN, STEP_B, "timg")):
        for tag, (arch, *_rest) in cases.items():
            cfg = get_config(arch)
            if cfg.family == "vlm":
                key = (name, arch)
                if key not in made:
                    made[key] = rng.randn(batch, cfg.num_image_tokens,
                                          cfg.d_model).astype(np.float32)
                inputs[name, tag] = made[key]
    inputs["tokens"] = rng.randint(0, 256, (STEP_B, STEP_S + 1)).astype(
        np.int32)
    inputs["launch_state"] = _launch_state_in_ref_layout()
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env, serve, train = _env(), json.dumps(SERVE), json.dumps(TRAIN)
    # the reference processes: the shapes, the launcher's steps and a
    # third of serving; each other third of serving; each quarter of the
    # training steps
    def part(cases, i, n):
        return json.dumps({k: cases[k] for k in sorted(cases)[i::n]})
    args = ([(part(SERVE, 0, 3), "{}", "1")] +
            [(part(SERVE, i, 3), "{}", "0") for i in (1, 2)] +
            [("{}", part(TRAIN, i, REF_TRAIN_PARTS), "0")
             for i in range(REF_TRAIN_PARTS)])
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(path),
                               *a, str(tmp / f"ref{i}.npz")], env=env,
                              cwd=tmp, stderr=subprocess.PIPE, text=True)
             for i, a in enumerate(args)]
    outs = []
    for world in (2, 4):
        for rank in range(world):
            outs.append(tmp / f"rank{world}_{rank}.npz")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, str(rank), str(world),
                 str(tmp / f"store{world}"), str(path), str(outs[-1]),
                 serve, train], env=env, cwd=tmp, stderr=subprocess.PIPE,
                text=True))
    # each mesh's runs: 4 steps; 2 steps, then resumed to 4
    started = {f"{run}{mesh}": _launcher(tmp, f"{run}{mesh}",
                                      LAUNCH_STEPS if run == "whole" else 2,
                                      mesh)
            for mesh in LAUNCH_MESHES for run in ("whole", "resumed")}
    try:
        launched = {}
        for mesh in LAUNCH_MESHES:
            launched["whole" + mesh] = _wait(started["whole" + mesh])
            launched["first" + mesh] = _wait(started["resumed" + mesh])
            started["resumed" + mesh] = _launcher(tmp, "resumed" + mesh,
                                                  LAUNCH_STEPS, mesh)
        for mesh in LAUNCH_MESHES:
            launched["resumed" + mesh] = _wait(started["resumed" + mesh])
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    ref = {k: v for i in range(len(args)) for k, v in np.load(
        tmp / f"ref{i}.npz").items()}
    return ref, [dict(np.load(o)) for o in outs], launched, tmp


def _sub(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def _outside(have: dict, want: dict, limit) -> tuple:
    """(elements outside limit(name, want), elements)."""
    assert set(have) == set(want)
    out = total = 0
    for n, w in want.items():
        out += int((np.abs(have[n] - w) > limit(n, w)).sum())
        total += w.size
    return out, total


class _Axis(RankMesh):
    """A stand-in mesh: rank ``(d, m)`` of a ``D x M`` mesh (one data rank
    unless ``D`` says more) and no process group (the layout needs no
    collective)."""

    def __init__(self, M, m, D=1, d=0):
        super().__init__()
        object.__setattr__(self, "shape", (D, M))
        object.__setattr__(self, "at", {"data": d, "model": m})

    def size(self, dim=None):
        return self.shape[dim]

    def get_local_rank(self, mesh_dim=None):
        return self.at[mesh_dim]


# ------------------------------------------------------------ shard shapes
@pytest.mark.parametrize("M", FULL_M)
@pytest.mark.parametrize("arch", FULL + FULL_FAMILIES)
def test_each_rank_holds_the_references_shard_shapes(runs, arch, M):
    """Every rank of a 1 x M model axis holds each leaf at the shape of
    the reference's ``NamedSharding(mesh, param_specs(...)).shard_shape``
    on the same mesh (a stacked leaf without its repeat axis): 1/M of
    every leaf whose spec has ``model`` on a dimension (heads, FFN and
    shared-expert hidden units, vocabulary, experts; MLA's, Mamba2's,
    cross-attention's and the MTP layer's), the rest whole. Full
    configs, on ``meta`` tensors."""
    ref = _sub(runs[0], f"shape|{arch}|{M}|")
    cfg = get_config(arch)
    whole = model.init(ShapesOnly(), cfg)
    flat_whole = tree.flatten_with_names(whole)
    stacks = model.layer_stacks(cfg)
    split = 0
    for m in range(M):
        ctx = ModelContext(mesh=_Axis(M, m), moe_impl="ep")
        flat = tree.flatten_with_names(convert.local_tp_params(whole, cfg,
                                                               ctx))
        seen = set()
        for name, t in flat.items():
            parts = name.split("/")
            if parts[0] == "layers":
                key = "/".join([stacks[int(parts[1][1:-1])]] + parts[2:])
                want = tuple(ref[key][1:])
            else:
                key, want = name, tuple(ref[name])
            seen.add(key)
            assert tuple(t.shape) == want, (name, tuple(t.shape), want)
            split += t.shape != flat_whole[name].shape
        assert seen == set(ref)
    # every attention, FFN, expert and vocabulary leaf of every layer
    assert split == M * len(TP.layout(cfg, ModelContext(
        mesh=_Axis(M, 0), moe_impl="ep")))
    assert split >= M * (2 + 4 * cfg.num_layers)


@pytest.mark.parametrize("D, M", FULL_DM, ids=lambda v: str(v))
@pytest.mark.parametrize("arch", FULL)
def test_each_data_rank_holds_the_references_fsdp_shard_shapes(runs, arch,
                                                               D, M):
    """Every rank ``(d, m)`` of a ``D x M`` mesh holds each leaf at the
    shape of the reference's ``NamedSharding(mesh, param_specs(...))
    .shard_shape`` on the same mesh (a stacked leaf without its repeat
    axis): ``1/D`` of every leaf whose spec has ``data`` on a dimension
    the axis divides, and on the model axis as at ``1 x M``. Full
    configs, on ``meta`` tensors."""
    ref = _sub(runs[0], f"shape|{arch}|{D}x{M}|")
    cfg = get_config(arch)
    whole = model.init(ShapesOnly(), cfg)
    stacks = model.layer_stacks(cfg)
    for d in range(D):
        for m in range(M):
            ctx = ModelContext(mesh=_Axis(M, m, D, d), moe_impl="ep")
            flat = tree.flatten_with_names(convert.local_tp_params(
                whole, cfg, ctx))
            seen = set()
            for name, t in flat.items():
                parts = name.split("/")
                if parts[0] == "layers":
                    key = "/".join([stacks[int(parts[1][1:-1])]] + parts[2:])
                    want = tuple(ref[key][1:])
                else:
                    key, want = name, tuple(ref[name])
                seen.add(key)
                assert tuple(t.shape) == want, (name, tuple(t.shape), want)
            assert seen == set(ref)
    layout = TP.layout(cfg, ModelContext(mesh=_Axis(M, 0, D, 0),
                                         moe_impl="ep"))
    data = [n for n, c in layout.items() if c.data is not None]
    # every layer's attention and FFN leaves and unembed, over the data axis
    assert len(data) >= 1 + 7 * cfg.num_layers, len(data)


def test_fsdp_dim_follows_the_rules_and_divisibility():
    """``fsdp_dim`` reads the data-axis entry of the reference's rule,
    guarded by divisibility over the data axis alone, for any block's
    leaf; a dim that the axis does not divide stays whole."""
    cases = [
        (("wq", (64, 32), 2), 0),
        (("wo", (32, 64), 4), 1),
        (("unembed", (64, 512), 2), 0),
        (("embed", (512, 64), 2), None),                 # model only
        (("w1", (8, 64, 32), 2), 1),                     # experts [E,d,ff]
        (("w2", (8, 32, 64), 2), 2),                     # experts [E,ff,d]
        (("w2", (32, 64), 2), 1),
        (("proj", (128, 64), 4), 0),                     # MTP
        (("wq_a", (64, 16), 2), 0),                      # MLA
        (("out_proj", (96, 64), 2), 1),                  # Mamba2
        (("wq", (6, 32), 4), None),                      # 6 over 4
        (("wo", (32, 10), 4), None),                     # 10 over 4
        (("w1", (8, 6, 32), 4), None),                   # 6 over 4
        (("wq", (64, 32), 3), None),                     # 64 over 3
        (("ln", (64,), 2), None),
        (("router", (64, 8), 2), None),
        (("gate", (), 2), None),
        (("unknown", (64, 64), 2), None),
        (("wq", (64, 32), 1), None),
    ]
    for args, want in cases:
        assert sharding.fsdp_dim(*args) == want, args


def test_split_dim_follows_the_rules_and_the_heads():
    """``split_dim`` reads the model-axis entry of the reference's rule,
    guarded by divisibility, for the leaves of the blocks it names; an
    MLA or Mamba2 block splits only when its heads divide, a GQA block
    wherever the guard keeps its entry (KV heads that do not divide run
    context-parallel)."""
    cases = [
        (("wq", "attn", (64, 64), 2, (4, 2)), 1),
        (("bk", "attn", (32,), 2, (4, 2)), 0),
        (("wo", "attn", (64, 64), 2, (4, 2)), 0),
        (("wq", "attn", (64, 64), 4), 1),                # KV 2 over 4
        (("wk", "attn", (64, 32), 4), 1),
        (("wo", "attn", (64, 64), 16), 0),               # 4 heads over 16
        (("wk", "attn", (64, 32), 64), None),            # 32 over 64
        (("w1", "ffn", (64, 128), 4), 1),
        (("w2", "ffn", (128, 64), 4), 0),
        (("w2", "ffn", (6, 64), 4), None),               # 6 over 4
        (("w1", "moe", (8, 64, 32), 2), None),           # routed experts
        (("sh_w3", "moe", (64, 32), 2), 1),
        (("embed", "top", (512, 64), 2), 0),
        (("unembed", "top", (64, 512), 2), 1),
        (("final_ln", "top", (64,), 2), None),
        (("wq_b", None, (16, 64), 2), None),             # no block
        (("wq", "attn", (64, 64), 1, (4, 2)), None),
        # MLA: the heads' columns of wq_b, wk_b, wv_b and rows of wo
        (("wq_b", "mla", (16, 96), 2, (4,)), 1),
        (("wv_b", "mla", (16, 64), 4, (4,)), 1),
        (("wo", "mla", (64, 64), 2, (4,)), 0),
        (("wq_a", "mla", (64, 16), 2, (4,)), None),      # whole
        (("wk_b", "mla", (16, 64), 8, (4,)), None),      # 4 heads over 8
        # Mamba2: in_proj columns, conv channels, out_proj rows
        (("in_proj", "mamba", (64, 296), 2, (8,)), 1),
        (("in_proj", "mamba", (64, 298), 4, (8,)), None),  # 298 over 4
        (("conv_w", "mamba", (4, 160), 4, (8,)), 1),
        (("conv_b", "mamba", (160,), 2, (8,)), 0),
        (("out_proj", "mamba", (128, 64), 4, (8,)), 0),
        (("A_log", "mamba", (8,), 2, (8,)), None),       # whole
        (("out_proj", "mamba", (128, 64), 16, (8,)), None),  # 8 over 16
    ]
    for args, want in cases:
        assert sharding.split_dim(*args) == want, args


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_matches_the_references_sharded_calls(runs, case):
    """Every rank's prefill logits (gathered over the vocabulary) equal
    the reference's jitted, sharded prefill at its data shard's rows
    (float32 within 1e-5 of the largest |logit|, bf16 within 5e-2), and
    ``engine.generate``'s greedy ids equal the reference's in float32:
    the same on every rank. The KV cache holds each rank's KV heads where
    the heads split; at (1, 4) the smoke's 2 KV heads do not divide, and
    its attention runs context-parallel (every leaf cut, the q rows split;
    a cache of 19 rows does not divide over 4: whole). On a data axis of two
    ranks each rank holds its FSDP block of the d_model rows and gathers
    each layer in prefill and decode."""
    ref, per_rank, _, _ = runs
    arch, over, D, M, hints, dtype = SERVE[case]
    got = [r for r in per_rank if f"serve|{case}|logits" in r]
    assert len(got) == D * M
    want, want_ids = ref[f"serve|{case}|logits"], ref[f"serve|{case}|ids"]
    tol = TOL32 if dtype == "float32" else TOL_BF16
    cfg = dataclasses.replace(get_config(arch), **over)
    tp = M if not hints.get("no_tp") else 1
    heads = cfg.num_kv_heads % tp == 0
    for r in got:
        rows = r[f"serve|{case}|rows"]
        w = want[rows]
        gap = np.abs(r[f"serve|{case}|logits"] - w).max() / np.abs(w).max()
        assert gap <= tol, (case, gap)
        if dtype == "float32":
            np.testing.assert_array_equal(r[f"serve|{case}|ids"],
                                          want_ids[rows])
        if arch not in (DENSE, MOE):
            _check_family_layout(ref, r, case, cfg, D, M)
            continue
        shapes = _sub(r, f"serve|{case}|shape|")
        kv = cfg.num_kv_heads // (tp if heads else 1)
        assert tuple(r[f"serve|{case}|kv"])[2] == kv
        hd = cfg.head_dim
        # the data axis cuts wq's d_model rows (FSDP)
        assert tuple(shapes["layers/[0]/attn/wq"]) == (
            cfg.d_model // D, cfg.num_heads * hd // tp)
        vp = cfg.padded_vocab_size // (1 if hints.get("no_tp") else M)
        assert tuple(shapes["embed"]) == (vp, cfg.d_model)
        assert tuple(shapes["unembed"]) == (cfg.d_model // D, vp)


def _check_family_layout(ref, r, case, cfg, D, M):
    """A FAMILIES case's rank holds every leaf at the reference device's
    shard shape (a stacked leaf without its repeat axis), and its caches
    hold its heads: a GQA layer's KV heads, a Mamba2 layer's SSD heads
    (the state ``[B, h/M, p, N]``, the conv tail its ``d_inner/M``
    channels with ``B`` and ``C``), the MLA latent's ``1/M`` of its last
    dimension (the reference's ``cache_specs``: ``kv_lora_rank`` and the
    rope dim cut over the model axis, which divides them and the heads
    here), a cross-attention layer's none."""
    want = _sub(ref, f"serve|{case}|shard|")
    have = _sub(r, f"serve|{case}|shape|")
    stacks = model.layer_stacks(cfg)
    seen = set()
    for name, shape in have.items():
        parts = name.split("/")
        if parts[0] == "layers":
            key = "/".join([stacks[int(parts[1][1:-1])]] + parts[2:])
            w = tuple(want[key][1:])
        else:
            key, w = name, tuple(want[name])
        seen.add(key)
        assert tuple(shape) == w, (case, name, tuple(shape), w)
    assert seen == set(want)
    B = SERVE_B // D
    rows = PROMPT + NEW
    for i, spec in enumerate(model.layer_specs(cfg)):
        got = [tuple(r[f"serve|{case}|cache|{i}|{j}"]) for j in range(2)
               if f"serve|{case}|cache|{i}|{j}" in r]
        if spec.kind == "cross_attn":
            wants = []
        elif spec.kind == "mla":
            assert not (cfg.num_heads % M or cfg.kv_lora_rank % M or
                        cfg.qk_rope_head_dim % M)
            wants = [(B, rows, cfg.kv_lora_rank // M),
                     (B, rows, cfg.qk_rope_head_dim // M)]
        elif spec.kind == "mamba":
            wants = [(B, cfg.ssm_conv - 1, cfg.ssm_d_inner // M +
                      2 * cfg.ssm_ngroups * cfg.ssm_state),
                     (B, cfg.ssm_heads // M, cfg.ssm_head_dim,
                      cfg.ssm_state)]
        else:
            wants = [(B, rows, cfg.num_kv_heads // M, cfg.head_dim)] * 2
        assert got == wants, (case, i, got, wants)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("case", sorted(TRAIN))
def test_train_step_matches_the_references_sharded_step(runs, case):
    """Every rank's step, its split leaves gathered, equals the
    reference's step jitted with ``in_shardings`` on the same mesh and
    hints: loss, ce and grad_norm within 1e-5 relative, every parameter,
    both moments and a compressed step's error buffer within 1e-5 of
    each leaf's largest |value| but for the flip budget."""
    ref, per_rank, _, _ = runs
    _, _, D, M, _, kw = TRAIN[case]
    got = [r for r in per_rank if f"train|{case}|metric|loss" in r]
    assert len(got) == D * M
    for r in got:
        for k in ("loss", "ce", "grad_norm"):
            want = float(ref[f"train|{case}|metric|{k}"])
            have = float(r[f"train|{case}|metric|{k}"])
            assert abs(have - want) <= TOL32 * abs(want), (k, have, want)
        for key in ("params", "mu", "nu"):
            pre = f"train|{case}|{key}|"
            out, total = _outside(_sub(r, pre), _sub(ref, pre),
                                  lambda n, w: TOL32 * np.abs(w).max())
            assert out <= FLIP_BUDGET * total, (key, out, total)
        if kw.get("grad_compression"):
            _check_err(ref, r, f"train|{case}")


#: the opened cases without routed experts, whose gradients no routing
#: choice moves
ROUTE_FREE = tuple(sorted(t for t in OPENED
                          if get_config(TRAIN[t][0]).family != "moe"))


@pytest.mark.parametrize("case", ROUTE_FREE)
def test_family_step_moments_match_leaf_by_leaf(runs, case):
    """The first moment after one step is ``(1 - b1)`` times the clipped
    gradient, with no sign to flip: for the cases of ``FAMILIES`` and
    ``gemma-1x2-seq`` without routed experts every rank's ``mu`` of every
    leaf, its split leaves gathered, within 1e-4 of that leaf's largest
    |value| (the card's gradient bound) with no element outside. A whole
    leaf whose gradient a rank sees through its heads only (Mamba2's
    ``A_log``, ``D``, ``dt_bias``, ``gnorm``) and is not summed over the
    model axis fails here, where the tree-wide flip budget would hide a
    small leaf. (In the MoE family a token whose expert choice or
    capacity drop differs between two equally valid float32 orders moves
    every gradient it reaches; there the flip budget holds and the loss
    and grad_norm catch a missing sum: ``wkv_a``'s, MLA's.)"""
    ref, per_rank, _, _ = runs
    _, _, D, M, _, _ = TRAIN[case]
    got = [r for r in per_rank if f"train|{case}|metric|loss" in r]
    assert len(got) == D * M
    want = _sub(ref, f"train|{case}|mu|")
    for r in got:
        have = _sub(r, f"train|{case}|mu|")
        assert set(have) == set(want)
        for n, w in want.items():
            gap = np.abs(have[n] - w).max()
            assert gap <= MU_TOL * max(np.abs(w).max(), 1e-30), (case, n,
                                                                  gap)


@pytest.mark.parametrize("when", ("init", "step"))
@pytest.mark.parametrize("case", SHARDS)
def test_each_rank_holds_the_reference_devices_shards(runs, case, when):
    """Rank ``(d, m)``'s own blocks of the parameters and both moments,
    after ``convert.local_tp_state`` (``init``) and after one step
    (``step``), equal the addressable shard of the reference's device at
    ``(d, m)`` under its ``param_specs`` (a stacked leaf with its repeat
    axis): every leaf's shape exactly, the values within 1e-5 of each
    leaf's largest |value| but for the flip budget. A block order that
    put the model axis's cut before the data axis's would fail here."""
    ref, per_rank, _, _ = runs
    _, _, D, M, _, _ = TRAIN[case]
    got = [r for r in per_rank if f"shard|{case}|at" in r]
    assert len(got) == D * M
    assert sorted(tuple(r[f"shard|{case}|at"]) for r in got) == [
        (d, m) for d in range(D) for m in range(M)]
    for r in got:
        d, m = r[f"shard|{case}|at"]
        for key in ("params", "mu", "nu"):
            have = _sub(r, f"shard|{case}|{when}|{key}|")
            want = _sub(ref, f"shard|{case}|{when}|{key}|{d}{m}|")
            for n, w in want.items():
                assert have[n].shape == w.shape, (n, have[n].shape, w.shape)
            out, total = _outside(have, want, lambda n, w: TOL32 * max(
                np.abs(w).max(), 1e-30))
            assert out <= FLIP_BUDGET * total, (key, d, m, out, total)


def _check_err(ref, got, tag):
    """The error buffer of a compressed step against the reference's, as
    tests/test_torch_moe_ep_train.py holds it: within the gradient's own
    tolerance plus one bf16 rounding but for the flip budget, and within
    one int8 step everywhere. A leaf's gradient maximum comes from the
    reference's first moment: ``mu = (1 - b1) · clip · deq(q(g))`` after
    one step from zero, and ``deq(q(g))`` keeps ``max |g|``."""
    b1 = OptimizerConfig().b1
    clip = min(1.0, OptimizerConfig().clip_norm
               / float(ref[f"{tag}|metric|grad_norm"]))
    gmax = {n: np.abs(m).max() / ((1 - b1) * clip)
            for n, m in _sub(ref, f"{tag}|mu|").items()}
    have, want = _sub(got, f"{tag}|err|"), _sub(ref, f"{tag}|err|")
    out, total = _outside(have, want, lambda n, w: (
        TOL32 * gmax[n] + np.abs(w) * 2.0 ** -8))
    assert out <= FLIP_BUDGET * total, ("err", out, total)
    out, _ = _outside(have, want, lambda n, w: (
        1.01 * gmax[n] / 127 + np.abs(w) * 2.0 ** -8))
    assert out == 0, ("err", out)


def test_hints_of_the_context_reach_every_layout():
    """Both layout hints are the caller's: ``no_tp`` adds the model axis
    to the data axes and defaults the MoE route to dense, and splits
    nothing; ``seq_shard_residual`` holds where the positions divide,
    for every family, under the dense MoE route and over a vocabulary
    that does not split (those two steps are held to the reference's in
    ``tests/test_torch_moe_ep_train.py``, ``GRADS``). The mesh fields
    stay refused."""
    assert set(sharding.REFUSED_CONTEXT) == {"mesh", "model_axis",
                                             "data_axes"}
    two = _Axis(2, 1)
    plain = ModelContext(mesh=two, moe_impl="ep")
    no_tp = dataclasses.replace(plain, no_tp=True, moe_impl="dense",
                                data_axes=("data", "model"))
    seq = dataclasses.replace(plain, seq_shard_residual=True)
    assert (plain.tp_size, no_tp.tp_size, no_tp.data_axes_size) == (2, 1, 2)
    assert (seq.seq_parallel, TP.for_sequence(seq, 16).seq_parallel,
            TP.for_sequence(seq, 1).seq_parallel) == (True, True, False)
    cfg = get_config(DENSE)
    assert TP.layout(cfg, no_tp) == {} and TP.plan(cfg, no_tp) == TP.WHOLE
    got = TP.plan(cfg, plain)
    assert (got.ways, got.rank, got.attn, got.ffn, got.vocab) == \
        (2, 1, True, True, True)
    # the KV cache holds each rank's KV heads
    caches = model.init_cache(cfg, 1, 4, device="meta", ctx=plain)
    assert caches[0][0].shape == (1, 4, cfg.num_kv_heads // 2, cfg.head_dim)
    # every family takes the hint (the local/global family's step under
    # it: the "gemma-1x2-seq" case), the dense MoE route and a vocabulary
    # that does not split included
    for arch in ("gemma3-4b-smoke",) + tuple(FAMILIES.values()):
        assert TP.plan(get_config(arch), seq).seq
    dense = TP.plan(get_config(MOE), dataclasses.replace(
        seq, moe_impl="dense"))
    assert (dense.seq, dense.shared) == (True, True)
    three = TP.plan(cfg, dataclasses.replace(seq, mesh=_Axis(3, 1)))
    assert (three.seq, three.vocab, three.ways, three.rank) == \
        (True, False, 3, 1)
    # a whole vocabulary under the hint: the rank's positions looked up
    ids = torch.arange(12)[None, :] % cfg.vocab_size
    table = torch.arange(cfg.padded_vocab_size, dtype=torch.float32
                         )[:, None].expand(-1, 2)
    assert TP.embed(table, ids, three)[0, :, 0].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="local_tp_params"):
        L.attn_block(model.init(ShapesOnly(), cfg)["layers"][0]["attn"],
                     torch.zeros(1, 4, cfg.d_model, device="meta"), cfg,
                     plain)


# ---------------------------------------------------------------- launcher
def _check_launcher(runs, mesh):
    ref, _, launched, tmp = runs
    for run in ("whole", "first", "resumed"):
        assert launched[run + mesh][1] == "", run
    printed = {}
    for run in ("whole", "first", "resumed"):
        for line in launched[run + mesh][0].splitlines():
            if line.startswith("step "):
                step = int(line.split()[1])
                printed[run, step] = float(line.split("loss=")[1].split()[0])
    assert set(printed) == {("whole", 4), ("first", 2), ("resumed", 4)}
    assert "resumed from step 2" in launched["resumed" + mesh][0]
    for (_, step), loss in printed.items():
        want = float(ref[f"launch-{mesh}|loss|{step}"])
        assert abs(loss - want) <= TOL_BF16 * abs(want), (step, loss, want)
    state, _ = restore_pytree(os.path.join(tmp / ("whole" + mesh), "step_4"),
                              like=_launch_state())
    cfg = get_config(DENSE)
    for key, got in (("params", state["params"]),
                     ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"])):
        have = tree.flatten_with_names(convert.export_reference_params(
            got, cfg))
        out, total = _outside(have, _sub(ref, f"launch-{mesh}|{key}|"),
                              lambda n, w: TOL_BF16 * np.abs(w).max())
        assert out <= FLIP_BUDGET * total, (key, out, total)


def test_launcher_over_two_ranks_matches_the_references_steps(runs):
    """``python -m repro_torch.launch.train --model-parallel 2 --device
    cpu`` at ``qwen2-7b-smoke`` over 2 gloo ranks: rank 0 alone prints;
    its losses are the reference's jitted (1, 2) steps' on the launcher's
    batches from the port's initial state (bf16), and its step-4
    checkpoint holds the reference's whole leaves within the bf16 bound
    and the flip budget."""
    _check_launcher(runs, "mp")


def test_launcher_over_two_data_ranks_matches_the_references_steps(runs):
    """The same at ``--data-parallel 2`` (FSDP): the reference's jitted
    (2, 1) steps, each rank on one row and its block of the state."""
    _check_launcher(runs, "dp")


def _check_resumed(runs, mesh):
    _, _, _, tmp = runs
    a, _ = restore_pytree(os.path.join(tmp / ("whole" + mesh), "step_4"))
    b, _ = restore_pytree(os.path.join(tmp / ("resumed" + mesh), "step_4"))
    assert set(a) == set(b) and int(a["step"]) == LAUNCH_STEPS
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name
    # whole leaves: a world of one's names and shapes
    one = {n: tuple(t.shape)
           for n, t in tree.flatten_with_names(_launch_state()).items()}
    assert {n: a[n].shape for n in a} == one
    cfg = get_config(DENSE)
    for key in ("params", "opt/mu", "opt/nu"):
        assert a[f"{key}/layers/[0]/attn/wq"].shape == (
            cfg.d_model, cfg.num_heads * cfg.head_dim)
        assert a[f"{key}/embed"].shape == (cfg.padded_vocab_size,
                                           cfg.d_model)
    assert sorted(os.listdir(tmp / ("resumed" + mesh))) == ["step_2",
                                                            "step_4"]


def test_launcher_resumed_over_two_ranks_equals_an_uninterrupted_run(runs):
    """2 steps, then a resume to 4, equals 4 uninterrupted steps byte for
    byte; the checkpoints hold whole leaves (``wq`` of all 4 heads, the
    whole vocabulary), a world of one's names and shapes."""
    _check_resumed(runs, "mp")


def test_launcher_resumed_over_two_data_ranks_equals_an_uninterrupted_run(
        runs):
    """The same at ``--data-parallel 2``: the checkpoint gathers each
    leaf's blocks over the data axis, and the resume cuts them again."""
    _check_resumed(runs, "dp")
