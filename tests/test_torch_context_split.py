"""The decode caches cut as the reference's ``cache_specs`` cuts them,
against the reference on the CPU: a batch of 1 on more than one data rank
(the context split: each data rank holds its contiguous ``rows / D`` of
every attention cache's sequence, ``layers.ContextSplit``, and the
decode's softmax parts are merged over the data axes,
``layers.merge_softmax_parts``), and the MLA latent cache cut over the
model axis (``layers.latent_ways``, ``layers._latent_decode``).

The reference runs in one subprocess on 4 forced host devices: a
``(data, model)`` mesh with Auto axes, its prefill jitted with
``in_shardings`` from its ``param_specs``, then its decode steps jitted
with the caches' ``cache_specs`` (the batch-1 caches cut on the sequence
over ``data``, the latent on its last dimension over ``model``). The
port runs as spawned gloo ranks (a ``FileStore`` under the test's
temporary directory, no socket). Inputs come from numpy seeds; the
reference's parameters reach the port through ``models.convert``.

Configs: ``gemma3-4b-smoke`` (a window of 8 on a cache of 24 rows, so
the ring's rows spread over the ranks, and a global layer),
``zamba2-2.7b-smoke`` (its shared attention layer's cache cut; the
Mamba2 state stays whole, ROADMAP §3), ``mamba2-370m-smoke`` (no
attention cache: nothing is cut) and ``deepseek-v3-671b-smoke`` (MLA's
latent at a model axis of 2). The prompt is a multiple of the window,
where the reference's prompt cache is a ring (ROADMAP §3).

Tolerances: float32 logits within 1e-5 of the largest |logit| at every
step and the greedy ids equal (``tests/test_torch_tensor_parallel.py``'s).
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
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL32 = 1e-5
CHUNK = 8
#: (arch, data, model, context hints, batch)
CASES = {
    "gemma-2x1": ("gemma3-4b-smoke", 2, 1, {}, 1),
    "gemma-4x1": ("gemma3-4b-smoke", 4, 1, {}, 1),
    "gemma-1x2-notp": ("gemma3-4b-smoke", 1, 2, {"no_tp": True}, 1),
    "gemma-2x2": ("gemma3-4b-smoke", 2, 2, {}, 1),
    "zamba-2x1": ("zamba2-2.7b-smoke", 2, 1, {}, 1),
    "zamba-4x1": ("zamba2-2.7b-smoke", 4, 1, {}, 1),
    "mamba-2x1": ("mamba2-370m-smoke", 2, 1, {}, 1),
    "v3-1x2": ("deepseek-v3-671b-smoke", 1, 2, {}, 2),
    "v3-2x2": ("deepseek-v3-671b-smoke", 2, 2, {}, 2),
}
#: a prompt that is a multiple of the window (8), and a cache whose rows
#: divide over 2 and 4 data ranks
PROMPT, NEW = 16, 8
CACHE_LEN = PROMPT + NEW
RANKS_TIMEOUT_S = 600

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding import cache_specs, make_context, param_specs
from repro.models import model
inputs = pickle.load(open(sys.argv[1], "rb"))
out = {}
for tag, (arch, D, M, hints, B) in json.loads(sys.argv[2]).items():
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    mesh = jax.make_mesh((D, M), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:D * M])
    ctx = make_context(mesh, remat="none", q_chunk=%(chunk)d,
                       k_chunk=%(chunk)d, **hints)
    named = lambda t: jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), t,
        is_leaf=lambda x: isinstance(x, P))
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params", arch])
    ps = named(param_specs(params, mesh, no_tp=ctx.no_tp))
    tokens = jnp.asarray(inputs["prompt"][:B])
    prefill = jax.jit(lambda p, t: model.prefill(
        p, t, cfg, ctx, cache_len=%(cache_len)d), in_shardings=(ps, None))
    with mesh:
        caches, logits = prefill(params, tokens)
        cs = named(cache_specs(caches, mesh))
        caches = jax.device_put(caches, cs)
        decode = jax.jit(lambda p, c, t, pos: model.decode_step(
            p, c, t, pos, cfg, ctx), in_shardings=(ps, cs, None, None),
            out_shardings=(cs, None))
        steps = [np.asarray(logits, np.float32)]
        for i in range(%(new)d):
            ids = jnp.argmax(logits, -1)[:, None]
            caches, logits = decode(params, caches, ids,
                                    jnp.int32(%(prompt)d + i))
            steps.append(np.asarray(logits, np.float32))
    out[f"{tag}|logits"] = np.stack(steps)
np.savez(sys.argv[3], **out)
""" % dict(chunk=CHUNK, cache_len=CACHE_LEN, new=NEW, prompt=PROMPT)

RANK = """
import dataclasses, json, pickle, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                        rank=rank, world_size=world)
from repro_torch.configs import get_config
from repro_torch.device import set_device
from repro_torch.distributed import data_parallel
from repro_torch.distributed.sharding import make_context
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, model
from repro_torch.train.train_step import data_shard
set_device("cpu")
inputs = pickle.load(open(sys.argv[4], "rb"))
out = {}
for tag, (arch, D, M, hints, B) in json.loads(sys.argv[6]).items():
    if D * M != world:
        continue
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    mesh = make_host_mesh(D, M)
    ctx = make_context(mesh, q_chunk=%(chunk)d, k_chunk=%(chunk)d, **hints)
    # a batch that does not divide is the whole batch on every data rank
    ctx = dataclasses.replace(ctx, batch_replicated=bool(
        B %% ctx.data_axes_size))
    whole = convert.import_reference_params(inputs["params", arch], cfg)
    params = convert.local_tp_params(whole, cfg, ctx)
    rows = torch.arange(B)
    if B %% ctx.data_axes_size == 0:
        # a batch that divides: this data shard's rows
        rows = data_shard({"tokens": rows}, ctx)["tokens"]
    out[f"{tag}|rows"] = rows.numpy()
    tokens = torch.from_numpy(inputs["prompt"][:B].astype(np.int64))[rows]
    caches, logits = model.prefill(params, tokens, cfg, ctx,
                                   cache_len=%(cache_len)d)
    steps = [logits.numpy()]
    for i in range(%(new)d):
        ids = logits.argmax(-1)[:, None]
        caches, logits = model.decode_step(params, caches, ids,
                                           %(prompt)d + i, cfg, ctx)
        steps.append(logits.numpy())
    out[f"{tag}|logits"] = np.stack(steps)
    out[f"{tag}|data_rank"] = np.asarray(data_parallel.data_rank(ctx))
    for i, c in enumerate(caches):
        out[f"{tag}|split|{i}"] = np.bool_(type(c).__name__ ==
                                           "ContextSplit")
        for j, t in enumerate(c):
            out[f"{tag}|cache|{i}|{j}"] = np.asarray(t.shape)
np.savez(sys.argv[5], **out)
dist.destroy_process_group()
""" % dict(chunk=CHUNK, cache_len=CACHE_LEN, new=NEW, prompt=PROMPT)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's ranks for worlds of 2
    and 4, started together. Returns (reference, [each rank's
    results])."""
    tmp = tmp_path_factory.mktemp("context_split")
    rng = np.random.RandomState(5)
    inputs = {"prompt": rng.randint(0, 256, (2, PROMPT)).astype(np.int32)}
    for arch in sorted({a for a, *_ in CASES.values()}):
        params = jax.jit(jmodel.init, static_argnums=1)(
            jax.random.PRNGKey(1), dataclasses.replace(jget_config(arch),
                                                       dtype="float32"))
        # open the zero-initialised norms and biases
        inputs["params", arch] = jax.tree_util.tree_map(
            lambda a: np.asarray(a if a.ndim > 1 else a + 0.1 * jnp.asarray(
                rng.randn(*a.shape), a.dtype)), params)
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env, cases = _env(), json.dumps(CASES)
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(path),
                               cases, str(tmp / "ref.npz")], env=env,
                              cwd=tmp, stderr=subprocess.PIPE, text=True)]
    outs = []
    for world in (2, 4):
        for rank in range(world):
            outs.append(tmp / f"rank{world}_{rank}.npz")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, str(rank), str(world),
                 str(tmp / f"store{world}"), str(path), str(outs[-1]),
                 cases], env=env, cwd=tmp, stderr=subprocess.PIPE,
                text=True))
    try:
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "ref.npz")), [dict(np.load(o)) for o in outs]


def _ranks(per_rank, case):
    _, D, M, _, _ = CASES[case]
    got = [r for r in per_rank if f"{case}|logits" in r]
    assert len(got) == D * M
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_on_cut_caches_matches_the_references(runs, case):
    """Every rank's prefill and decode logits within 1e-5 of the largest
    |logit| of the reference's decode under ``cache_specs``, at every
    step, and its greedy ids equal (a batch that divides over the data
    axes: the rank's rows of it)."""
    ref, per_rank = runs
    for r in _ranks(per_rank, case):
        want = ref[f"{case}|logits"][:, r[f"{case}|rows"]]
        have = r[f"{case}|logits"]
        assert have.shape == want.shape
        for step, (h, w) in enumerate(zip(have, want)):
            gap = np.abs(h - w).max()
            assert gap <= TOL32 * np.abs(w).max(), (case, step, gap)
        assert (have.argmax(-1) == want.argmax(-1)).all(), case


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_its_part_of_the_caches(runs, case):
    """A batch that does not divide over the D data ranks: each attention
    layer's (k, v) holds ``rows / D`` of its ring (a ``ContextSplit``),
    the Mamba2 state its whole heads; the MLA latent ``1/M`` of its last
    dimension where the model axis divides it and the heads."""
    arch, D, M, hints, B = CASES[case]
    cfg = get_config(arch)
    if hints.get("no_tp"):
        D, M = D * M, 1
    cut = B % D != 0
    B = B if cut else B // D            # the rank's rows
    for r in _ranks(per_rank=runs[1], case=case):
        for i, spec in enumerate(model.layer_specs(cfg)):
            shapes = [tuple(r[f"{case}|cache|{i}|{j}"]) for j in range(2)]
            split = bool(r[f"{case}|split|{i}"])
            rows = model.cache_rows(spec, CACHE_LEN)
            if spec.kind == "mla":
                lat = M if not (cfg.num_heads % M or cfg.kv_lora_rank % M or
                                cfg.qk_rope_head_dim % M) else 1
                assert shapes == [(B, rows, cfg.kv_lora_rank // lat),
                                  (B, rows, cfg.qk_rope_head_dim // lat)]
                assert not split
            elif spec.kind == "mamba":
                assert shapes[1] == (B, cfg.ssm_heads // M,
                                     cfg.ssm_head_dim, cfg.ssm_state)
                assert not split
            else:
                assert split == cut, (case, i)
                want = rows // D if cut else rows
                assert shapes[0][:2] == shapes[1][:2] == (B, want)


def test_each_data_rank_holds_other_rows(runs):
    """The data ranks' row blocks are the ``D`` contiguous blocks of the
    ring: each data rank index once."""
    for case, (_, D, M, hints, _) in CASES.items():
        got = _ranks(runs[1], case)
        n = D * M if hints.get("no_tp") else D
        assert sorted({int(r[f"{case}|data_rank"]) for r in got}) == \
            list(range(n))


def test_softmax_parts_of_one_rank_are_the_softmax():
    """Over groups of one rank (none), the merged parts are the softmax;
    a part whose rows are all masked is zeros, not NaN."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(2, 3, 4, 10, generator=g)
    v = torch.randn(2, 10, 3, 5, generator=g)
    valid = torch.arange(10) < 7
    want = torch.einsum("bgrk,bkgd->bgrd", torch.softmax(
        torch.where(valid, s, torch.tensor(-1e30)), dim=-1), v)
    got = L.merge_softmax_parts(*L.softmax_parts(s, valid, v), ())
    assert torch.allclose(got, want, atol=1e-6)
    m, l, o = L.softmax_parts(s, torch.zeros(10, dtype=torch.bool), v)
    assert bool((l == 0).all()) and bool((o == 0).all())
    assert not torch.isnan(o).any() and bool((m == -1e30).all())


def test_a_context_split_needs_a_replicated_batch():
    """``context_ways``: D where the context says the batch is the same
    on every one of D data ranks (``batch_replicated``), else 1; without
    a mesh 1."""
    class Ctx:
        mesh, data_axes_size, batch_replicated = object(), 4, True
    assert L.context_ways(Ctx()) == 4
    Ctx.batch_replicated = False
    assert L.context_ways(Ctx()) == 1
    assert L.context_ways(None) == 1
