"""Context-parallel GQA attention for KV heads that do not divide over
the model axis (``tensor_parallel.Plan.cp``, ``models.layers.attn_block``)
against the reference's jitted sharded calls on the CPU.

The reference partitions such a block by its rules: ``wq``, ``wk``,
``wv`` (and biases) cut on their columns, ``wo`` on its rows, the
attention's q chunks split over ``model`` where they divide over it
(``src/repro/models/layers.py:205-213``), and a decode step's cache cut
on its sequence over ``model`` (``cache_specs``). The port's ranks hold
the same blocks, exchange q into their rows of every head
(``tensor_parallel.to_rows``), gather k and v over their columns, and
decode on caches cut on the sequence over the model axis
(``layers.ModelSplit``), merging each rank's part of the softmax.

The reference runs in one subprocess on 4 forced host devices: a
``(data, model)`` mesh of (1, 4) with Auto axes, its prefill jitted with
``in_shardings`` from its ``param_specs``, its decode steps with the
caches' ``cache_specs``, and ``jax.value_and_grad`` of its ``lm_loss``
(``remat="full"``) with the parameters' shardings. The port runs as 4
spawned gloo ranks (a ``FileStore`` under the test's temporary
directory, no socket). Inputs come from numpy seeds; the reference's
parameters, their norms, biases and gates opened by seeded noise, reach
the port through ``models.convert``.

Cases (``CASES``): ``qwen2-7b-smoke`` (4/2 heads) with 4 q chunks (the
rows split, 8 a rank) and with 3 (they do not divide: every rank
attends with every row, the leaves still cut), the same under the
sequence-split residual, ``gemma3-4b-smoke`` (a window of 8 on a ring
of 8 rows, 2 a rank; its k and v column blocks are half a head) and
``llama-3.2-vision-90b-smoke``'s cross-attention layer (non-causal rows
over the image embeddings).

Tolerances: float32 logits within 1e-5 of the largest |logit| at every
step and the greedy ids equal; every gradient leaf within 1e-5 of its
largest |value| (``tests/test_torch_tensor_parallel.py``'s).
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
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import make_context
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import layers as L
from repro_torch.models import model
from repro_torch.models.layers import ShapesOnly

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL32 = 1e-5
D, M = 1, 4
#: tag -> (arch, prompt, q_chunk, context hints): a prompt of 32 at a
#: chunk of 8 has 4 q chunks (one a rank), of 24 three (whole rows)
CASES = {
    "qwen-rows": ("qwen2-7b-smoke", 32, 8, {}),
    "qwen-whole-rows": ("qwen2-7b-smoke", 24, 8, {}),
    "qwen-rows-seq": ("qwen2-7b-smoke", 32, 8, {"seq_shard_residual": True}),
    "gemma-rows": ("gemma3-4b-smoke", 32, 8, {}),
    "vlm-rows": ("llama-3.2-vision-90b-smoke", 32, 8, {}),
}
#: the batch, the decode steps and the cache's rows past the prompt (the
#: caches' rows divide over the 4 ranks)
B, NEW, EXTRA = 2, 3, 4
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
from repro_torch import tree
inputs = pickle.load(open(sys.argv[1], "rb"))
D, M, NEW, EXTRA = %(D)d, %(M)d, %(new)d, %(extra)d
out = {}
mesh = jax.make_mesh((D, M), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:D * M])
named = lambda t: jax.tree_util.tree_map(
    lambda s: NamedSharding(mesh, s), t, is_leaf=lambda x: isinstance(x, P))
for tag, (arch, S, qc, hints) in json.loads(sys.argv[2]).items():
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    ctx = make_context(mesh, remat="none", q_chunk=qc, k_chunk=qc, **hints)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params", arch])
    ps = named(param_specs(params, mesh))
    img = {}
    if ("img", arch) in inputs:
        img = {"image_embeds": jnp.asarray(inputs["img", arch])}
    tokens = jnp.asarray(inputs["tokens"][:, :S])
    prefill = jax.jit(lambda p, t, e: model.prefill(
        p, t, cfg, ctx, cache_len=S + EXTRA, **e), in_shardings=(ps, None,
                                                                 None))
    with mesh:
        caches, logits = prefill(params, tokens, img)
        cs = named(cache_specs(caches, mesh))
        caches = jax.device_put(caches, cs)
        decode = jax.jit(lambda p, c, t, pos, e: model.decode_step(
            p, c, t, pos, cfg, ctx, **e), in_shardings=(ps, cs, None, None,
                                                       None),
            out_shardings=(cs, None))
        steps = [np.asarray(logits, np.float32)]
        for i in range(NEW):
            ids = jnp.argmax(logits, -1)[:, None]
            caches, logits = decode(params, caches, ids, jnp.int32(S + i),
                                    img)
            steps.append(np.asarray(logits, np.float32))
        out[f"{tag}|logits"] = np.stack(steps)
        tctx = make_context(mesh, remat="full", q_chunk=qc, k_chunk=qc,
                            **hints)
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: model.lm_loss(p, b, cfg, tctx), has_aux=True),
            in_shardings=(ps, None))
        batch = {"tokens": jnp.asarray(inputs["tokens"][:, :S + 1]), **img}
        (loss, _), g = grad(params, batch)
    out[f"{tag}|loss"] = np.asarray(loss, np.float32)
    for n, a in tree.flatten_with_names(g).items():
        out[f"{tag}|grad|{n}"] = np.asarray(a, np.float32)
np.savez(sys.argv[3], **out)
""" % dict(D=D, M=M, new=NEW, extra=EXTRA)

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
from repro_torch.models import convert, layers as L, model
from repro_torch.train import train_step as ts
set_device("cpu")
inputs = pickle.load(open(sys.argv[4], "rb"))
D, M, NEW, EXTRA = %(D)d, %(M)d, %(new)d, %(extra)d
mesh = make_host_mesh(D, M)
out = {}
calls = []
real = L.attention


def spy(q, k, v, **kw):
    calls.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
    return real(q, k, v, **kw)


L.attention = spy
for tag, (arch, S, qc, hints) in json.loads(sys.argv[6]).items():
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    ctx = make_context(mesh, q_chunk=qc, k_chunk=qc, **hints)
    whole = convert.import_reference_params(inputs["params", arch], cfg)
    params = convert.local_tp_params(whole, cfg, ctx)
    for n, t in tree.flatten_with_names(params).items():
        out[f"{tag}|param|{n}"] = np.asarray(t.shape)
    img = {}
    if ("img", arch) in inputs:
        img = {"image_embeds": torch.from_numpy(inputs["img", arch])}
    tokens = torch.from_numpy(inputs["tokens"].astype(np.int64))
    del calls[:]
    caches, logits = model.prefill(params, tokens[:, :S], cfg, ctx,
                                   cache_len=S + EXTRA, **img)
    out[f"{tag}|calls"] = np.asarray(calls)
    for i, c in enumerate(caches):
        out[f"{tag}|axis|{i}"] = np.asarray(getattr(c, "axis", ""))
        for j, t in enumerate(c):
            out[f"{tag}|cache|{i}|{j}"] = np.asarray(t.shape)
    steps = [logits.numpy()]
    for i in range(NEW):
        ids = logits.argmax(-1)[:, None]
        caches, logits = model.decode_step(params, caches, ids, S + i, cfg,
                                           ctx, **img)
        steps.append(logits.numpy())
    out[f"{tag}|logits"] = np.stack(steps)
    tctx = dataclasses.replace(ctx, remat="full")
    batch = {"tokens": tokens[:, :S + 1], **img}
    met, g = ts.make_grads_fn(cfg, tctx)(params, batch)
    g = data_parallel.gather_split(g, tctx, TP.layout(cfg, tctx))
    out[f"{tag}|loss"] = met["loss"].numpy()
    for n, a in tree.flatten_with_names(
            convert.export_reference_params(g, cfg)).items():
        out[f"{tag}|grad|{n}"] = a
np.savez(sys.argv[5], **out)
dist.destroy_process_group()
""" % dict(D=D, M=M, new=NEW, extra=EXTRA)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4 ranks, started
    together. Returns (reference, [each rank's results])."""
    tmp = tmp_path_factory.mktemp("context_parallel")
    rng = np.random.RandomState(7)
    longest = max(S for _, S, _, _ in CASES.values())
    inputs = {"tokens": rng.randint(0, 256, (B, longest + 1)).astype(
        np.int32)}
    for arch in sorted({a for a, *_ in CASES.values()}):
        cfg = dataclasses.replace(jget_config(arch), dtype="float32")
        params = jax.jit(jmodel.init, static_argnums=1)(
            jax.random.PRNGKey(2), cfg)
        # open the zero-initialised norms, biases and gates
        inputs["params", arch] = jax.tree_util.tree_map(
            lambda a: np.asarray(a if a.ndim > 1 else a + 0.1 * jnp.asarray(
                rng.randn(*a.shape), a.dtype)), params)
        if cfg.cross_attn_every:
            inputs["img", arch] = rng.randn(
                B, cfg.num_image_tokens, cfg.d_model).astype(np.float32)
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env, cases = _env(), json.dumps(CASES)
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(path),
                               cases, str(tmp / "ref.npz")], env=env,
                              cwd=tmp, stderr=subprocess.PIPE, text=True)]
    outs = [tmp / f"rank{r}.npz" for r in range(D * M)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(D * M), str(tmp / "store"),
         str(path), str(outs[r]), cases], env=env, cwd=tmp,
        stderr=subprocess.PIPE, text=True) for r in range(D * M)]
    try:
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "ref.npz")), [dict(np.load(o)) for o in outs]


def _sub(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_the_references(runs, case):
    """Every rank's prefill and decode logits (the cache cut on its
    sequence over the model axis) within 1e-5 of the largest |logit| of
    the reference's calls under ``cache_specs``, at every step; the
    greedy ids equal."""
    ref, ranks = runs
    want = ref[f"{case}|logits"]
    for r in ranks:
        have = r[f"{case}|logits"]
        assert have.shape == want.shape
        for step, (h, w) in enumerate(zip(have, want)):
            gap = np.abs(h - w).max()
            assert gap <= TOL32 * np.abs(w).max(), (case, step, gap)
        assert (have.argmax(-1) == want.argmax(-1)).all(), case


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_the_references(runs, case):
    """One train step's gradient (``make_grads_fn``, the split leaves
    gathered) against ``jax.value_and_grad`` of the reference's
    ``lm_loss`` jitted over the same mesh: the loss within 1e-5
    relative, every leaf, the attention leaves among them, within 1e-5
    of its largest |value|."""
    ref, ranks = runs
    want = _sub(ref, f"{case}|grad|")
    assert any("/attn/wq" in n for n in want)
    for r in ranks:
        loss, wloss = float(r[f"{case}|loss"]), float(ref[f"{case}|loss"])
        assert abs(loss - wloss) <= TOL32 * abs(wloss)
        have = _sub(r, f"{case}|grad|")
        assert set(have) == set(want)
        for n, w in want.items():
            gap = np.abs(have[n] - w).max()
            assert gap <= TOL32 * max(np.abs(w).max(), 1e-30), (case, n, gap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_its_blocks_and_cache_rows(runs, case):
    """A rank's parameter bytes are the whole leaves' plus 1/M of the cut
    ones (every attention leaf among them), and its attention caches
    1/M of their rows: a ``ModelSplit`` of ``rows / M`` rows of every KV
    head; the cross-attention layer has none."""
    arch, S, _, hints = CASES[case]
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    ctx = make_context(RankMesh(("data", "model"), (D, M)), **hints)
    cuts = TP.layout(cfg, ctx)
    whole = tree.flatten_with_names(model.init(ShapesOnly(), cfg))
    attn = [n for n in whole if "/attn/" in n and n.rsplit("/", 1)[1] in
            ("wq", "wk", "wv", "wo", "bq", "bk", "bv")]
    assert attn and set(attn) <= set(cuts)
    want = sum(t.numel() * 4 // (M if n in cuts else 1)
               for n, t in whole.items())
    for r in runs[1]:
        shapes = _sub(r, f"{case}|param|")
        assert set(shapes) == set(whole)
        assert sum(int(np.prod(s)) * 4 for s in shapes.values()) == want
        for i, spec in enumerate(model.layer_specs(cfg)):
            got = [tuple(r[f"{case}|cache|{i}|{j}"]) for j in range(2)
                   if f"{case}|cache|{i}|{j}" in r]
            if spec.kind == "cross_attn":
                assert got == []
                continue
            rows = model.cache_rows(spec, S + EXTRA)
            assert str(r[f"{case}|axis|{i}"]) == "model"
            assert got == [(B, rows // M, cfg.num_kv_heads,
                            cfg.head_dim)] * 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_rows_split_where_the_q_chunks_divide(runs, case):
    """A prefill's self-attention calls: where the q chunks divide over
    the ranks, each rank attends with its ``S/M`` rows at ``q_offset =
    rank · S/M`` against all S keys; where they do not, with all S rows
    at offset 0. The cross-attention layer's rows split the same way
    against the image tokens."""
    arch, S, qc, _ = CASES[case]
    cfg = get_config(arch)
    split = L.row_split(S, qc, M)
    assert split == (case != "qwen-whole-rows")
    offsets = set()
    for r in runs[1]:
        calls = [tuple(c) for c in r[f"{case}|calls"]]
        assert len(calls) == cfg.num_layers
        for sq, skv, off in calls:
            assert sq == (S // M if split else S)
            assert skv in (S, cfg.num_image_tokens)
            offsets.add(off)
    assert offsets == ({m * S // M for m in range(M)} if split else {0})


def test_the_exchanges_are_each_others_inverse():
    """``to_rows`` gives rank m the ``S/M`` rows of every column block in
    rank order, and ``to_columns`` takes them back; over a counted
    group (the dry-run's stand-in) each is one all-to-all of the
    tensor's bytes, shapes only."""
    plan = TP.Plan(ways=4, rank=1, group=C.CountedGroup("model", 4))
    x = torch.empty(2, 16, 6, device="meta")
    with C.recording() as tally:
        rows = TP.to_rows(x, plan)
        back = TP.to_columns(rows, plan)
    assert rows.shape == (2, 4, 24) and back.shape == x.shape
    assert tally.calls == {("all-to-all", 4): [2, 2 * 2 * 16 * 6 * 4]}
    assert TP.to_rows(x, TP.WHOLE) is x


def test_the_plan_routes_by_the_kv_heads():
    """The reference's route condition, ``KV % M == 0``: the dense
    smoke's 2 KV heads split over 2 and run context-parallel over 4; the
    full ``qwen2-7b`` (28/4) splits its heads over 4 and runs
    context-parallel over 8 and 16; an MLA block never takes it."""
    def plan(arch, m):
        return TP.plan(get_config(arch), make_context(
            RankMesh(("data", "model"), (1, m))))
    assert (plan("qwen2-7b-smoke", 2).attn, plan("qwen2-7b-smoke", 2).cp) \
        == (True, False)
    assert (plan("qwen2-7b-smoke", 4).attn, plan("qwen2-7b-smoke", 4).cp) \
        == (False, True)
    for m, want in ((4, False), (8, True), (16, True)):
        assert plan("qwen2-7b", m).cp is want
    assert plan("deepseek-v3-671b-smoke", 2).mla
    assert L.cache_axis(get_config("qwen2-7b-smoke"), make_context(
        RankMesh(("data", "model"), (1, 4))), 36) == "model"
    assert L.cache_axis(get_config("qwen2-7b-smoke"), make_context(
        RankMesh(("data", "model"), (1, 4))), 18) is None
