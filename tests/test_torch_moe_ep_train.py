"""Training through the port's expert-parallel MoE path against the
reference, on the CPU: ``models.moe.routed_ep``'s backward, the train
step on a ``data x model`` mesh (``distributed.data_parallel``) and the
launcher over gloo ranks, at ``deepseek-moe-16b-smoke`` (8 experts,
top-2, 1 shared expert of 32; d 64) and, for the data axis alone,
``qwen2-7b-smoke``.

Inputs come from numpy seeds; the reference's parameters and training
states reach the port through ``models.convert``. On one rank the port
runs in this process over a gloo world of one, against ``jax.grad`` of
the reference's ``routed_ep`` on a ``(1, 1)`` Auto mesh. On 2 and 4
ranks it runs as spawned gloo ranks (a ``FileStore`` under the test's
temporary directory, no socket), against the reference's
``make_train_step`` jitted with ``in_shardings`` over the same mesh, in
one subprocess on 4 forced host devices (the reference launcher's
setup). Every rank's gathered state is held to the reference's.

Tolerances are ``tests/test_torch_lm_train.py``'s: float32 1e-5 of a
leaf's largest |value| (``TOL32``), the loss and ``grad_norm`` 1e-5
relative, at most 0.1% of a tree's elements outside after an AdamW step
(``FLIP_BUDGET``: the sign of the first step on a near-zero gradient);
bf16 (the launcher's dtype) 5e-2.

The layouts the port once refused (``GRADS``), each held to the
reference's ``jax.value_and_grad`` of ``lm_loss`` and to its jitted step
on the same mesh: the dense MoE route over two data ranks, explicit on
(2, 1) and as the ``no_tp`` hint's default on (1, 2), whose aux is the
global batch's; that route under ``seq_shard_residual``; ``routed_ep``
under autograd on a sequence that does not divide over the model axis
(every rank routes every position); and ``qwen2-7b-smoke`` under the
hint on a model axis of 3, over which its vocabulary of 256 does not
split (a mesh over 3 of the 4 forced host devices). Loss, ce, aux and
the gradient norm within 1e-5 relative, every gradient leaf within 1e-5
of its largest |value|, and the step's state within the flip budget.

The aux term over a data axis above 1: the reference's ``routed_ep``
returns its model-axis mean under ``out_specs P()`` with
``check_vma=False``, so its jitted step reports the first data shard's
aux (and a loss with it), while its gradient is that of the data
shards' mean (the transpose divides the replicated cotangent over the
devices). The port's step reports the first shard's aux too
(``data_parallel.global_metrics``) and averages the gradients over the
data axes, which is that gradient: the (2, 2) cases hold it with the
aux term in the loss.
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
import torch.distributed as dist
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.distributed.sharding import make_context as jmake_context
from repro.models import moe as JMOE
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import tree
from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import get_config
from repro_torch.device import use_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, moe
from repro_torch.models.layers import ModelContext
from repro_torch.train import OptimizerConfig
from repro_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, DENSE = "deepseek-moe-16b-smoke", "qwen2-7b-smoke"
TOL32, TOL_BF16, FLIP_BUDGET = 1e-5, 5e-2, 1e-3
B, S = 2, 16
CHUNK = 16
LR = 1e-3
#: (arch, data, model, step kwargs): plain steps on every mesh; a
#: microbatched and a compressed step on the meshes with a data axis
#: (whose microbatches shard over it) and a model axis of 2 and 4
CASES = {
    "moe-1x2": (ARCH, 1, 2, {}),
    "moe-1x4": (ARCH, 1, 4, {}),
    "moe-2x2": (ARCH, 2, 2, {}),
    "moe-1x4-compressed": (ARCH, 1, 4, {"grad_compression": True}),
    "moe-2x2-microbatch": (ARCH, 2, 2, {"microbatch": 2}),
    "moe-2x2-compressed": (ARCH, 2, 2, {"grad_compression": True}),
    "dense-2x1": (DENSE, 2, 1, {}),
    "dense-2x1-microbatch": (DENSE, 2, 1, {"microbatch": 2}),
    "dense-2x1-compressed": (DENSE, 2, 1, {"grad_compression": True}),
}
#: the layouts the port once refused: (arch, data, model, context
#: hints, sequence); a gradient and a step each
GRADS = {
    "dense-route-2x1": (ARCH, 2, 1, {"moe_impl": "dense"}, 16),
    "dense-route-notp-1x2": (ARCH, 1, 2, {"no_tp": True}, 16),
    "dense-route-seq-1x2": (ARCH, 1, 2, {"moe_impl": "dense",
                                         "seq_shard_residual": True}, 16),
    "dense-route-seq-2x2": (ARCH, 2, 2, {"moe_impl": "dense",
                                         "seq_shard_residual": True}, 16),
    "odd-1x2": (ARCH, 1, 2, {}, 13),
    "odd-2x2": (ARCH, 2, 2, {}, 13),
    "odd-1x4": (ARCH, 1, 4, {}, 13),
    "vocab-1x3-seq": (DENSE, 1, 3, {"seq_shard_residual": True}, 15),
}
STEP_B, STEP_S = 4, 16
#: the launcher's run: bf16 (the config's), 1 x 2 ranks, batches of
#: LAUNCH_B x LAUNCH_S, 4 steps, a checkpoint every 2
LAUNCH_B, LAUNCH_S, LAUNCH_STEPS = 2, 16, 4
#: a wait limit for the spawned processes, not a tolerance (300 until
#: the refused layouts' cases doubled the reference's work)
RANKS_TIMEOUT_S = 600


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jmesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one in this process, destroyed after the module."""
    with use_device("cpu"):
        m = make_host_mesh(1, 1)
    yield m
    dist.destroy_process_group()


# ------------------------------------------------------- one rank, in-process
@pytest.mark.parametrize("cf", [1.25, 4.0], ids=["drops", "no-drop"])
def test_ep_block_gradients_match_jax_grad_on_one_rank(mesh, cf):
    """The MoE block through ``routed_ep`` on a world of one: its float32
    gradients (``x``, router, experts, ``ln``, shared experts) under a
    random cotangent of ``y`` and a weight on ``aux`` equal ``jax.grad``
    of the reference's block on a (1, 1) mesh; at 1.25 pairs drop, at
    ``E/k`` none does."""
    jcfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    jp = JMOE.init_moe(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(3)
    x = (0.5 * rng.randn(B, S, cfg.d_model)).astype(np.float32)
    cot = rng.randn(B, S, cfg.d_model).astype(np.float32)
    jctx = jmake_context(_jmesh((1, 1)), remat="none", capacity_factor=cf)
    ctx = sharding.make_context(mesh, capacity_factor=cf)

    def jloss(p, x):
        y, aux = JMOE.moe_block(p, x, jcfg, jctx)
        return jnp.sum(y * cot) + 3.0 * aux
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))

    tp = {n: convert.to_tensor(np.asarray(a)).requires_grad_()
          for n, a in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_block(tp, tx, cfg, ctx)
    loss = (y * torch.from_numpy(cot)).sum() + 3.0 * aux
    grads = torch.autograd.grad(loss, [tx] + list(tp.values()))
    assert abs(loss.item() - float(jl)) <= TOL32 * abs(float(jl))
    assert _rel(grads[0], jgx) <= TOL32, "x"
    for (name, _), g in zip(tp.items(), grads[1:]):
        assert _rel(g, jgp[name]) <= TOL32, name
    # the drop path is reached at 1.25 and not at E/k
    xn = moe.L.rms_norm(tx.detach(), tp["ln"].detach(), cfg.norm_eps)
    _, idx, _ = moe.route(xn.reshape(B * S, -1), tp["router"].detach(),
                          cfg.experts_per_token)
    _, keep = moe.dispatch_slots(idx.reshape(-1), cfg.num_experts,
                                 moe.capacity(B * S, cfg, ctx))
    assert bool(keep.all()) == (cf == 4.0)


def test_ep_block_backward_repeats_its_bits(mesh):
    """Two backwards of the same block give the same bits: each pair
    reads its own row (a dropped one the spare zero row)."""
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy((0.5 * np.random.RandomState(4).randn(
        B, S, cfg.d_model)).astype(np.float32))
    ctx = sharding.make_context(mesh)
    runs = []
    for _ in range(2):
        leaves = {n: t.clone().requires_grad_() for n, t in p.items()
                  if n in ("router", "w1", "w3", "w2")}
        xi = x.clone().requires_grad_()
        y, aux = moe.routed_ep(xi, leaves, cfg, ctx)
        runs.append(torch.autograd.grad(
            y.square().sum() + aux, [xi] + list(leaves.values())))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------------ 2 and 4 ranks, spawned
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
out = {}


def step_fn(cfg, shape, kw, hints=None, grads=False):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    ctx = make_context(mesh, remat="full", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d, **(hints or {}))
    pspec = param_specs(inputs["state", cfg.name, False]["params"], mesh,
                        no_tp=ctx.no_tp)
    if grads:
        ns = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), pspec,
                                    is_leaf=lambda x: isinstance(x, P))
        return mesh, jax.jit(jax.value_and_grad(
            lambda p, b: model.lm_loss(p, b, cfg, ctx), has_aux=True),
            in_shardings=(ns, None))
    sspec = {"params": pspec, "opt": {"mu": pspec, "nu": pspec}, "step": P()}
    if kw.get("grad_compression"):
        sspec["err"] = pspec
    ns = lambda t: jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), t,
        is_leaf=lambda x: isinstance(x, P))
    fn = jax.jit(jts.make_train_step(
        cfg, ctx, jopt.OptimizerConfig(lr=%(lr)r, warmup_steps=10), **kw),
        in_shardings=(ns(sspec), None))
    return mesh, fn


def record(tag, state, metrics):
    for k in ("params", "mu", "nu", "err"):
        t = state["opt"][k] if k in ("mu", "nu") else state.get(k)
        if t is not None:
            for n, a in tree.flatten_with_names(t).items():
                out[f"{tag}|{k}|{n}"] = np.asarray(a, np.float32)
    for k, v in metrics.items():
        out[f"{tag}|metric|{k}"] = np.asarray(v, np.float32)


for tag, (arch, D, M, kw) in json.loads(sys.argv[2]).items():
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    state = inputs["state", cfg.name, bool(kw.get("grad_compression"))]
    mesh, fn = step_fn(cfg, (D, M), kw)
    with mesh:
        new, met = fn(state, {"tokens": jnp.asarray(inputs["tokens", arch])})
    record(tag, new, met)
# the layouts the port once refused: the gradient, then a step
for tag, (arch, D, M, hints, S) in json.loads(sys.argv[4]).items():
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    state = inputs["state", cfg.name, False]
    batch = {"tokens": jnp.asarray(inputs["gtokens", tag])}
    mesh, fn = step_fn(cfg, (D, M), {}, hints, grads=True)
    with mesh:
        (loss, met), g = fn(state["params"], batch)
    for n, a in tree.flatten_with_names(g).items():
        out[f"{tag}|grad|{n}"] = np.asarray(a, np.float32)
    for k, v in met.items():
        out[f"{tag}|gmetric|{k}"] = np.asarray(v, np.float32)
    mesh, fn = step_fn(cfg, (D, M), {}, hints)
    with mesh:
        new, met = fn(state, batch)
    record(tag, new, met)
# the launcher's run: bf16, (1, 2), from the port's initial state (in
# the process whose sys.argv[5] is "1")
if sys.argv[5] == "1":
    cfg = get_config(%(arch)r)
    state = inputs["launch_state"]
    mesh, fn = step_fn(cfg, (1, 2), {})
    rng = np.random.RandomState(1)
    with mesh:
        for i in range(%(steps)d):
            tokens = rng.randint(0, cfg.vocab_size,
                                 size=(%(lb)d, %(ls)d + 1)).astype(np.int32)
            state, met = fn(state, {"tokens": jnp.asarray(tokens)})
            out[f"launch|loss|{i + 1}"] = np.asarray(met["loss"],
                                                     np.float32)
    record("launch", state, {})
np.savez(sys.argv[3], **out)
""" % dict(chunk=CHUNK, lr=LR, arch=ARCH, steps=LAUNCH_STEPS, lb=LAUNCH_B,
           ls=LAUNCH_S)

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
from repro_torch.train import OptimizerConfig
from repro_torch.train import train_step as ts
set_device("cpu")
inputs = pickle.load(open(sys.argv[4], "rb"))
out = {}
for tag, (arch, D, M, kw) in json.loads(sys.argv[6]).items():
    if D * M != world:
        continue
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    mesh = make_host_mesh(D, M)
    ctx = make_context(mesh, remat="full", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d)
    whole = convert.import_reference_train_state(
        inputs["state", cfg.name, bool(kw.get("grad_compression"))], cfg)
    state = convert.local_tp_state(whole, cfg, ctx)
    tokens = torch.from_numpy(inputs["tokens", arch])
    batch = ts.data_shard({"tokens": tokens}, ctx, kw.get("microbatch", 0))
    new, met = ts.make_train_step(
        cfg, ctx, OptimizerConfig(lr=%(lr)r, warmup_steps=10), **kw)(
            state, batch)
    new = data_parallel.gather_split(new, ctx, TP.layout(cfg, ctx))
    trees = {"params": new["params"], "mu": new["opt"]["mu"],
             "nu": new["opt"]["nu"]}
    if "err" in new:
        trees["err"] = new["err"]
    for k, t in trees.items():
        for n, a in tree.flatten_with_names(
                convert.export_reference_params(t, cfg)).items():
            out[f"{tag}|{k}|{n}"] = a
    for k, v in met.items():
        out[f"{tag}|metric|{k}"] = v.numpy()
    out[f"{tag}|rows"] = batch["tokens"].numpy()
for tag, (arch, D, M, hints, S) in json.loads(sys.argv[7]).items():
    if D * M != world:
        continue
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    mesh = make_host_mesh(D, M)
    ctx = make_context(mesh, remat="full", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d, **hints)
    whole = convert.import_reference_train_state(
        inputs["state", cfg.name, False], cfg)
    state = convert.local_tp_state(whole, cfg, ctx)
    batch = ts.data_shard(
        {"tokens": torch.from_numpy(inputs["gtokens", tag])}, ctx)
    split = TP.layout(cfg, ctx)
    met, g = ts.make_grads_fn(cfg, ctx)(state["params"], batch)
    g = data_parallel.gather_split({"params": g}, ctx, split)["params"]
    for n, a in tree.flatten_with_names(
            convert.export_reference_params(g, cfg)).items():
        out[f"{tag}|grad|{n}"] = a
    for k, v in met.items():
        out[f"{tag}|gmetric|{k}"] = v.numpy()
    new, met = ts.make_train_step(
        cfg, ctx, OptimizerConfig(lr=%(lr)r, warmup_steps=10))(state, batch)
    new = data_parallel.gather_split(new, ctx, split)
    for k, t in (("params", new["params"]), ("mu", new["opt"]["mu"]),
                 ("nu", new["opt"]["nu"])):
        for n, a in tree.flatten_with_names(
                convert.export_reference_params(t, cfg)).items():
            out[f"{tag}|{k}|{n}"] = a
    for k, v in met.items():
        out[f"{tag}|metric|{k}"] = v.numpy()
np.savez(sys.argv[5], **out)
dist.destroy_process_group()
""" % dict(chunk=CHUNK, lr=LR)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _launcher(tmp, name, steps, world=2):
    """One launcher run over ``world`` gloo ranks (1 x world), its
    checkpoints under ``tmp/name``: the rank processes."""
    store = tmp / f"{name}.store"
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--model-parallel", str(world), "--batch",
         str(LAUNCH_B), "--seq", str(LAUNCH_S), "--steps", str(steps),
         "--ckpt-every", "2", "--ckpt", str(tmp / name), "--dist-init",
         f"file://{store}"], env=dict(_env(), RANK=str(rank),
                                      WORLD_SIZE=str(world)),
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def _wait(procs, timeout=RANKS_TIMEOUT_S):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _ in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything spawned, started together: the reference's jitted steps
    (``CASES`` and the launcher's four steps), the port's ranks for each
    world size, and the launcher's runs (4 steps; 2 steps, then resumed
    to 4). Returns (reference, [each rank's results], launcher outputs,
    the launcher's directory)."""
    tmp = tmp_path_factory.mktemp("ep_train")
    inputs = {}
    for arch in (ARCH, DENSE):
        jcfg = dataclasses.replace(jget_config(arch), dtype="float32")
        for compress in (False, True):
            inputs["state", jcfg.name, compress] = jax.tree_util.tree_map(
                np.asarray, jax.jit(lambda k: jts.make_train_state(
                    k, jcfg, jopt.OptimizerConfig(),
                    grad_compression=compress))(jax.random.PRNGKey(0)))
        inputs["tokens", arch] = np.random.RandomState(1).randint(
            0, jcfg.vocab_size, (STEP_B, STEP_S + 1)).astype(np.int32)
    for tag, (arch, _, _, _, seq) in GRADS.items():
        inputs["gtokens", tag] = np.random.RandomState(2).randint(
            0, get_config(arch).vocab_size, (STEP_B, seq + 1)).astype(
                np.int32)
    # the launcher's initial state, made by the port as the launcher makes
    # it, in the reference's layout and dtypes
    inputs["launch_state"] = _launch_state_in_ref_layout()
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env, cases, grads = _env(), json.dumps(CASES), json.dumps(GRADS)
    # the reference's processes: CASES and the launcher's steps; each half
    # of GRADS
    parts = [(cases, "{}", "1")] + [
        ("{}", json.dumps({k: GRADS[k] for k in sorted(GRADS)[i::2]}), "0")
        for i in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(path),
                               c, str(tmp / f"ref{i}.npz"), g, launch],
                              env=env, cwd=tmp, stderr=subprocess.PIPE,
                              text=True)
             for i, (c, g, launch) in enumerate(parts)]
    outs = []
    for world in sorted({D * M for _, D, M, *_ in (list(CASES.values()) +
                                                    list(GRADS.values()))}):
        for rank in range(world):
            outs.append(tmp / f"rank{world}_{rank}.npz")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, str(rank), str(world),
                 str(tmp / f"store{world}"), str(path), str(outs[-1]),
                 cases, grads], env=env, cwd=tmp, stderr=subprocess.PIPE,
                text=True))
    whole = _launcher(tmp, "whole", LAUNCH_STEPS)
    first = _launcher(tmp, "resumed", 2)
    try:
        launched = {"whole": _wait(whole), "first": _wait(first)}
        launched["resumed"] = _wait(_launcher(tmp, "resumed",
                                              LAUNCH_STEPS))
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    ref = {k: v for i in range(len(parts))
           for k, v in np.load(tmp / f"ref{i}.npz").items()}
    return (ref, [dict(np.load(o)) for o in outs],
            launched, tmp)


def _launch_state():
    """The launcher's initial state (``launch.train.train``'s)."""
    return ts.make_train_state(torch.Generator().manual_seed(0),
                               get_config(ARCH),
                               OptimizerConfig(lr=LR, warmup_steps=10))


def _launch_state_in_ref_layout():
    """``_launch_state`` in the reference's layout, each leaf in the
    dtype of the reference's state leaf (bf16 values widen and narrow
    exactly)."""
    cfg, state = get_config(ARCH), _launch_state()
    jshapes = jts.make_train_state_shapes(jget_config(ARCH),
                                          jopt.OptimizerConfig())
    exported = {"params": convert.export_reference_params(state["params"],
                                                          cfg),
                "opt": {k: convert.export_reference_params(v, cfg)
                        for k, v in state["opt"].items()},
                "step": np.zeros((), np.int32)}
    return jax.tree_util.tree_map(lambda a, sd: np.asarray(
        jnp.asarray(a, sd.dtype)), exported, jshapes)


def _outside(have: dict, want: dict, limit) -> tuple:
    """(elements outside limit(name, want), elements)."""
    assert set(have) == set(want)
    out = total = 0
    for n, w in want.items():
        out += int((np.abs(have[n] - w) > limit(n, w)).sum())
        total += w.size
    return out, total


def _check_err(ref, got, case):
    """The error buffer of a compressed step against the reference's, as
    tests/test_torch_lm_train.py holds it: within the gradient's own
    tolerance plus one bf16 rounding but for the flip budget, and within
    one int8 step everywhere. The reference's gradient maximum of a leaf
    comes from its first moment: ``mu = (1 - b1) · clip · deq(q(g))``
    after one step from zero, and ``deq(q(g))`` keeps ``max |g|``."""
    b1 = OptimizerConfig().b1
    gnorm = float(ref[f"{case}|metric|grad_norm"])
    clip = min(1.0, OptimizerConfig().clip_norm / gnorm)
    gmax = {n: np.abs(m).max() / ((1 - b1) * clip)
            for n, m in _tree(ref, case, "mu").items()}
    have, want = _tree(got, case, "err"), _tree(ref, case, "err")
    out, total = _outside(have, want, lambda n, w: (
        TOL32 * gmax[n] + np.abs(w) * 2.0 ** -8))
    assert out <= FLIP_BUDGET * total, ("err", out, total)
    out, _ = _outside(have, want, lambda n, w: (
        1.01 * gmax[n] / 127 + np.abs(w) * 2.0 ** -8))
    assert out == 0, ("err", out)


def _tree(rec, tag, key):
    pre = f"{tag}|{key}|"
    return {k[len(pre):]: v for k, v in rec.items() if k.startswith(pre)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_on_a_mesh_matches_the_references(runs, case):
    """Every rank's step, its split leaves gathered (its experts, and the
    heads, FFN hidden units and vocabulary rows that the model axis
    splits), equals the reference's
    jitted step on the same mesh: loss, ce, aux and grad_norm (the
    reference's global values; aux the first data shard's), every
    parameter and both moments within the flip budget, and the error
    buffer of a compressed step."""
    ref, per_rank, _, _ = runs
    arch, D, M, kw = CASES[case]
    got = [r for r in per_rank if f"{case}|metric|loss" in r]
    assert len(got) == D * M
    for r in got:
        for k in ("loss", "ce", "aux", "grad_norm"):
            want = float(ref[f"{case}|metric|{k}"])
            have = float(r[f"{case}|metric|{k}"])
            assert abs(have - want) <= TOL32 * abs(want), (k, have, want)
        for key in ("params", "mu", "nu"):
            out, total = _outside(_tree(r, case, key), _tree(ref, case, key),
                                  lambda n, w: TOL32 * np.abs(w).max())
            assert out <= FLIP_BUDGET * total, (key, out, total)
        if kw.get("grad_compression"):
            _check_err(ref, r, case)
    # every rank of a data shard took the same rows, the shards others
    rows = {int(np.asarray(r[f"{case}|rows"]).sum()) for r in got}
    assert len(rows) == D


def test_data_shards_take_the_references_microbatch_rows():
    """With a microbatch of 4 over 2 data ranks, shard d takes rows
    ``i·4 + 2d`` and ``+ 1`` of each microbatch i, not its contiguous
    half; a microbatch that does not divide over the shards raises."""
    class Mesh2:
        mesh_dim_names = ("data", "model")

        def size(self, dim=None):
            return (2, 1)[dim]

        def get_local_rank(self, mesh_dim=None):
            return {"data": 1, "model": 0}[mesh_dim]

    ctx = ModelContext(mesh=Mesh2(), moe_impl="ep")
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3)}
    assert ts.data_shard(batch, ctx, 4)["tokens"][:, 0].tolist() == \
        [2, 3, 6, 7]
    assert ts.data_shard(batch, ctx)["tokens"][:, 0].tolist() == \
        [4, 5, 6, 7]
    with pytest.raises(ValueError, match="data ranks"):
        ts.data_shard(batch, ctx, 3)
    with pytest.raises(ValueError, match="data ranks"):
        ts.make_train_step(get_config(DENSE), ctx, OptimizerConfig(),
                           microbatch=3)


@pytest.mark.parametrize("case", sorted(GRADS))
def test_refused_layouts_match_the_references_gradient(runs, case):
    """Each layout the port once refused, on every rank: loss, ce and aux
    (the reference's global values) within 1e-5 relative, and every
    gradient leaf, its split blocks gathered, within 1e-5 of the
    reference's leaf's largest |value| (``jax.value_and_grad`` of its
    ``lm_loss`` jitted over the same mesh)."""
    ref, per_rank, _, _ = runs
    _, D, M, _, _ = GRADS[case]
    got = [r for r in per_rank if f"{case}|gmetric|loss" in r]
    assert len(got) == D * M
    want = _tree(ref, case, "grad")
    for r in got:
        for k in ("loss", "ce", "aux"):
            w, h = float(ref[f"{case}|gmetric|{k}"]), \
                float(r[f"{case}|gmetric|{k}"])
            assert abs(h - w) <= TOL32 * abs(w), (k, h, w)
        have = _tree(r, case, "grad")
        assert set(have) == set(want)
        for n, w in want.items():
            gap = np.abs(have[n] - w).max()
            assert gap <= TOL32 * max(np.abs(w).max(), 1e-30), (n, gap)


@pytest.mark.parametrize("case", sorted(GRADS))
def test_refused_layouts_step_as_the_reference(runs, case):
    """The same layouts through ``make_train_step``: loss, ce, aux and
    grad_norm within 1e-5 relative, the parameters and both moments
    after AdamW within the flip budget."""
    ref, per_rank, _, _ = runs
    _, D, M, _, _ = GRADS[case]
    got = [r for r in per_rank if f"{case}|metric|loss" in r]
    assert len(got) == D * M
    for r in got:
        for k in ("loss", "ce", "aux", "grad_norm"):
            w, h = float(ref[f"{case}|metric|{k}"]), \
                float(r[f"{case}|metric|{k}"])
            assert abs(h - w) <= TOL32 * abs(w), (k, h, w)
        for key in ("params", "mu", "nu"):
            out, total = _outside(_tree(r, case, key), _tree(ref, case, key),
                                  lambda n, w: TOL32 * np.abs(w).max())
            assert out <= FLIP_BUDGET * total, (key, out, total)


def test_a_sequence_that_does_not_divide_matches_the_references_gradient(
        runs):
    """On a model axis of 2 and 4, a training sequence of 13 positions
    (every rank routes every position through ``routed_ep``) gives the
    reference's gradients: the expert leaves' are ``jax.grad``'s, not M
    times it, and the router's and the input's reach their sums."""
    ref, per_rank, _, _ = runs
    for case in ("odd-1x2", "odd-2x2", "odd-1x4"):
        M = GRADS[case][2]
        assert GRADS[case][4] % M
        want = {n: w for n, w in _tree(ref, case, "grad").items()
                if n.endswith(("ffn/w1", "ffn/w2", "ffn/w3", "ffn/router"))}
        assert want
        got = [r for r in per_rank if f"{case}|gmetric|loss" in r]
        assert len(got) == GRADS[case][1] * M
        for r in got:
            have = _tree(r, case, "grad")
            for n, w in want.items():
                gap = np.abs(have[n] - w).max()
                assert gap <= TOL32 * np.abs(w).max(), (case, n, gap)


# ---------------------------------------------------------------- launcher
def test_launcher_over_two_ranks_matches_the_references_steps(runs):
    """``python -m repro_torch.launch.train --model-parallel 2 --device
    cpu`` over 2 gloo ranks: rank 0 alone prints; its losses (4 decimals)
    are the reference's jitted (1, 2) steps' on the launcher's batches
    from the port's initial state, and its step-4 checkpoint holds the
    reference's whole leaves, within the bf16 bound and the flip
    budget."""
    ref, _, launched, tmp = runs
    for run in ("whole", "first", "resumed"):
        assert launched[run][1] == "", run
    printed = {}
    for run in ("whole", "first", "resumed"):
        for line in launched[run][0].splitlines():
            if line.startswith("step "):
                step = int(line.split()[1])
                printed[run, step] = float(line.split("loss=")[1].split()[0])
    assert set(printed) == {("whole", 4), ("first", 2), ("resumed", 4)}
    assert "resumed from step 2" in launched["resumed"][0]
    for (_, step), loss in printed.items():
        want = float(ref[f"launch|loss|{step}"])
        assert abs(loss - want) <= TOL_BF16 * abs(want), (step, loss, want)
    state, _ = restore_pytree(os.path.join(tmp / "whole", "step_4"),
                              like=_launch_state())
    assert int(state["step"]) == LAUNCH_STEPS
    cfg = get_config(ARCH)
    for key, got in (("params", state["params"]),
                     ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"])):
        have = tree.flatten_with_names(convert.export_reference_params(
            got, cfg))
        out, total = _outside(have, _tree(ref, "launch", key),
                              lambda n, w: TOL_BF16 * np.abs(w).max())
        assert out <= FLIP_BUDGET * total, (key, out, total)


def test_launcher_resumed_over_two_ranks_equals_an_uninterrupted_run(runs):
    """2 steps, then a resume to 4, equals 4 uninterrupted steps byte for
    byte; the checkpoints hold the reference's whole expert leaves
    (``[E, d, ff]``, every expert)."""
    _, _, _, tmp = runs
    a, _ = restore_pytree(os.path.join(tmp / "whole", "step_4"))
    b, _ = restore_pytree(os.path.join(tmp / "resumed", "step_4"))
    assert set(a) == set(b) and int(a["step"]) == LAUNCH_STEPS
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name
    cfg = get_config(ARCH)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for key in ("params", "opt/mu", "opt/nu"):
        assert a[f"{key}/layers/[1]/ffn/w1"].shape == (E, d, ff)
        assert a[f"{key}/layers/[3]/ffn/w2"].shape == (E, ff, d)
    assert sorted(os.listdir(tmp / "resumed")) == ["step_2", "step_4"]
