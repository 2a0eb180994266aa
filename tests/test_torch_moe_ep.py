"""The port's expert-parallel MoE path (``models.moe.routed_ep``) against
the reference's ``routed_ep`` at ``deepseek-moe-16b-smoke`` (8 experts,
top-2, 1 shared expert of 32; d 64) on the CPU.

Inputs come from numpy seeds. On one rank, the port runs in this process
over a gloo world of one (``launch.mesh.make_host_mesh`` under
``use_device("cpu")``), against the reference's ``"ep"`` context on a
``(1, 1)`` mesh. On 2 and 4 ranks, the port runs as spawned gloo ranks
(a ``FileStore`` under the test's temporary directory, no socket), and
the reference in one subprocess on forced host devices; rank ``(d, m)``
is held to the reference's rows of data shard ``d``.

Tolerances: float32 ``y`` within 1e-5, ``aux`` within 1e-6, the kept
(token, slot) masks equal; bf16 rtol = atol = 0.05 (tests/test_models.py's
bound for the MoE block); logits within 1e-4 and greedy ids equal.
"""
import dataclasses
import json
import os
import pathlib
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
from repro.models import model as jmodel
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.device import use_device
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.collectives import CountedGroup
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.models import convert, layers as L, moe
from repro_torch.serve import engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "deepseek-moe-16b-smoke"
CHUNK = 8
B, S, NEW = 2, 16, 3            # NEW: the prefill's token and two decodes
TOL32 = 1e-4
TOL_BLOCK = {"float32": 1e-5, "bfloat16": 0.05}
#: the multi-rank cases: meshes, and sequence lengths that divide over
#: the model axis (8) or are one decode position (1)
MESHES = [(1, 2), (1, 4), (2, 2)]
RANK_B, RANK_SEQS = 4, (8, 1)
RANKS_TIMEOUT_S = 240


def _cfgs(dtype):
    return (dataclasses.replace(jget_config(ARCH), dtype=dtype),
            dataclasses.replace(get_config(ARCH), dtype=dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _jmesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _ref_keep(xt: np.ndarray, router, k, E, cap) -> np.ndarray:
    """The reference's kept (token, slot) mask: its ``_route`` choices and
    its cumulative count per expert (``routed_ep``'s ``pos < cap``)."""
    _, idx, _ = JMOE._route(jnp.asarray(xt), router, k)
    ids = np.asarray(idx).reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[ids]
    pos = np.take_along_axis(np.cumsum(onehot, 0) - 1, ids[:, None], 1)[:, 0]
    return pos < cap


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one in this process, destroyed after the module."""
    with use_device("cpu"):
        m = make_host_mesh(1, 1)
    yield m
    dist.destroy_process_group()


# ------------------------------------------------------------ the context
def test_make_context_on_a_live_mesh_picks_ep(mesh):
    ctx = sharding.make_context(mesh, q_chunk=CHUNK)
    assert (ctx.mesh, ctx.moe_impl, ctx.model_axis, ctx.data_axes) == \
        (mesh, "ep", "model", ("data",))
    assert (ctx.model_axis_size, ctx.data_axes_size, ctx.capacity_factor) \
        == (1, 1, 1.25)
    assert sharding.make_context(mesh, moe_impl="dense").moe_impl == "dense"
    assert sharding.make_context(mesh, capacity_factor=2.0
                                 ).capacity_factor == 2.0
    with pytest.raises(ValueError, match="ROADMAP"):
        sharding.make_context(mesh, model_axis="model")
    # the reference's layout hints are the caller's: no_tp makes the model
    # axis a data axis and the MoE route dense
    hinted = sharding.make_context(mesh, no_tp=True, seq_shard_residual=True)
    assert (hinted.no_tp, hinted.seq_shard_residual, hinted.moe_impl,
            hinted.data_axes, hinted.tp_size, hinted.seq_parallel) == \
        (True, True, "dense", ("data", "model"), 1, False)
    plain = sharding.make_context(None)
    assert (plain.mesh, plain.moe_impl, plain.model_axis_size) == \
        (None, "dense", 1)
    # plain axis sizes (the dry-run's) give the one-rank stand-in
    counted = sharding.make_context({"data": 1, "model": 1})
    assert isinstance(counted.mesh, RankMesh)
    assert (counted.moe_impl, counted.model_axis_size,
            counted.data_axes_size, counted.mesh.get_group("model")) == \
        ("ep", 1, 1, None)
    # more ranks: the stand-in of the rank at the origin, whose model
    # axis's group is counted, not live
    two = sharding.make_context({"data": 1, "model": 2})
    assert (two.model_axis_size, two.mesh.get_local_rank("model"),
            two.mesh.get_group("model"), two.mesh.get_group("data")) == \
        (2, 0, CountedGroup("model", 2), None)
    with pytest.raises(ValueError, match="moe_impl"):
        L.ModelContext(moe_impl="sparse")


# ------------------------------------------------------- one rank, in-process
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_ep_block_matches_the_references_on_one_rank(mesh, dtype, cf):
    jcfg, cfg = _cfgs(dtype)
    jp = JMOE.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = {name: convert.to_tensor(np.asarray(a)) for name, a in jp.items()}
    x = (0.5 * np.random.RandomState(3).randn(B, S, cfg.d_model)
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = convert.to_tensor(np.asarray(jx))
    jctx = jmake_context(_jmesh((1, 1)), remat="none", q_chunk=CHUNK,
                         k_chunk=CHUNK, capacity_factor=cf)
    ctx = sharding.make_context(mesh, q_chunk=CHUNK, k_chunk=CHUNK,
                                capacity_factor=cf)
    assert jctx.moe_impl == ctx.moe_impl == "ep"
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_block(p, x, jcfg, jctx))(jp, jx)
    y, aux = moe.moe_block(tp, tx, cfg, ctx)
    assert y.dtype == tx.dtype and aux.dtype == torch.float32
    _close(y, jy, TOL_BLOCK[dtype])
    # the drop-free route differs from both where pairs were dropped
    dense, _ = moe.moe_block(tp, tx, cfg, L.ModelContext())
    gap = np.abs(_np(dense) - _np(jy)).max()
    if dtype == "float32":
        np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                                   atol=1e-6)
        xn = L.rms_norm(tx, tp["ln"], cfg.norm_eps).reshape(B * S, -1)
        _, idx, _ = moe.route(xn, tp["router"], cfg.experts_per_token)
        cap = moe.capacity(B * S, cfg, ctx)
        _, keep = moe.dispatch_slots(idx.reshape(-1), cfg.num_experts, cap)
        want = _ref_keep(xn.numpy(), jp["router"], cfg.experts_per_token,
                         cfg.num_experts, cap)
        np.testing.assert_array_equal(keep.numpy(), want)
        assert keep.all() == (cf == 8.0)
    else:
        _close(aux, jaux, TOL_BLOCK[dtype])
    assert (gap > 0.3) if cf == 1.25 else (gap < TOL_BLOCK[dtype])


def test_ep_without_drops_equals_routed(mesh):
    """At a capacity factor of E no pair is dropped: ``routed_ep`` is the
    drop-free combine that ``routed`` computes."""
    _, cfg = _cfgs("float32")
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy((0.5 * np.random.RandomState(4).randn(
        B, S, cfg.d_model)).astype(np.float32))
    ctx = sharding.make_context(mesh, capacity_factor=float(cfg.num_experts))
    got, aux = moe.routed_ep(x, p, cfg, ctx)
    want, want_aux = moe.routed(x.reshape(B * S, -1), p, cfg)
    _close(got.reshape(B * S, -1), want, 1e-5)
    _close(aux, want_aux, 1e-6)


def test_routed_ep_refuses_the_wrong_experts_and_a_backward(mesh):
    """The wrong experts raise; a backward runs on a world of one, and
    one whose sequence does not divide over the model axis runs on a
    stand-in mesh of two ranks (``meta`` tensors, the exchanges counted):
    every rank routes every position, and the backward reaches the input
    and each leaf (its values: ``tests/test_torch_moe_ep_train.py``)."""
    _, cfg = _cfgs("float32")
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg)
    ctx = sharding.make_context(mesh)
    x = torch.zeros(1, 2, cfg.d_model)
    half = dict(p, w1=p["w1"][:4], w3=p["w3"][:4], w2=p["w2"][:4])
    with pytest.raises(ValueError, match="local_experts"):
        moe.routed_ep(x, half, cfg, ctx)
    xg = torch.randn(1, 3, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).requires_grad_()
    y, aux = moe.routed_ep(xg, p, cfg, ctx)
    (g,) = torch.autograd.grad(y.sum() + aux, [xg])
    assert g.shape == xg.shape and bool(torch.isfinite(g).all())

    two = L.ModelContext(mesh=RankMesh(("data", "model"), (1, 2), (0, 1)),
                         moe_impl="ep")
    meta = {n: t.to("meta").requires_grad_() for n, t in half.items()}
    xm = xg.detach().to("meta").requires_grad_()
    with collectives.recording() as tally:
        y, aux = moe.routed_ep(xm, meta, cfg, two)
        grads = torch.autograd.grad(y.sum() + aux, [xm, meta["router"],
                                                    meta["w1"]])
    assert y.shape == xm.shape and [g.shape for g in grads] == [
        xm.shape, meta["router"].shape, meta["w1"].shape]
    # the exchanges both ways, and the input's gradient summed over the
    # axis
    assert tally.calls[("all-to-all", 2)][0] == 4
    assert ("all-reduce", 2) in tally.calls
    # one rank holds every expert: nothing is cut or copied
    assert moe.local_experts(p, ctx) is p
    params = {"layers": [{"ffn": p}], "embed": x}
    assert convert.local_expert_params(params, ctx)["layers"][0]["ffn"] is p


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def lm32():
    jcfg, cfg = _cfgs("float32")
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                     jcfg)
    params = convert.import_reference_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (B, S)
                                              ).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def test_ep_serving_matches_the_references(mesh, lm32):
    """Prefill and two decode steps through ``engine.generate`` with the
    ``"ep"`` context against the reference's ``prefill``/``decode_step``
    with its ``"ep"`` context; the drop-free route is far from both."""
    jcfg, cfg, jparams, params, tokens = lm32
    cache_len = S + NEW
    jctx = jmake_context(_jmesh((1, 1)), remat="none", q_chunk=CHUNK,
                         k_chunk=CHUNK)
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, t, jcfg, jctx,
                                                   cache_len=cache_len))
    jdecode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, c, t, pos, jcfg, jctx))
    jcaches, jl = jprefill(jparams, jnp.asarray(tokens))
    want_logits, want_ids = [jl], [np.asarray(jnp.argmax(jl, -1))]
    for i in range(NEW - 1):
        tok = jnp.asarray(want_ids[-1][:, None].astype(np.int32))
        jcaches, jl = jdecode(jparams, jcaches, tok, jnp.int32(S + i))
        want_logits.append(jl)
        want_ids.append(np.asarray(jnp.argmax(jl, -1)))

    t = torch.from_numpy(tokens.astype(np.int64))
    with use_device("cpu"):
        ctx = sharding.make_context(mesh, q_chunk=CHUNK, k_chunk=CHUNK)
        ids = engine.generate(params, t, cfg, ctx, max_new_tokens=NEW)
        np.testing.assert_array_equal(ids.numpy(), np.stack(want_ids, 1))
        for c, tol_check in ((ctx, True),
                             (L.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK),
                              False)):
            caches, logits = engine.make_prefill_step(cfg, c, cache_len)(
                params, t)
            got = [logits]
            for i in range(NEW - 1):
                caches, logits = engine.make_decode_step(cfg, c)(
                    params, caches, ids[:, i:i + 1], S + i)
                got.append(logits)
            diffs = [np.abs(_np(g) - _np(w)).max()
                     for g, w in zip(got, want_logits)]
            if tol_check:
                assert max(diffs) < TOL32, diffs
            else:
                assert min(diffs) > 100 * TOL32, diffs


# ------------------------------------------------ 2 and 4 ranks, spawned
REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed.sharding import make_context
from repro.models import moe
data = np.load(sys.argv[1])
cfg = dataclasses.replace(get_config(sys.argv[3]), dtype="float32")
p = {k: jnp.asarray(data[k]) for k in ("router", "w1", "w3", "w2")}
out = {}
for shape in json.loads(sys.argv[4]):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = make_context(mesh, remat="none")
    for s in json.loads(sys.argv[5]):
        y, aux = jax.jit(lambda p, x: moe.routed_ep(x, p, cfg, ctx))(
            p, jnp.asarray(data[f"x{s}"]))
        tag = f"{shape[0]}x{shape[1]}_S{s}"
        out[f"{tag}_y"], out[f"{tag}_aux"] = np.asarray(y), np.asarray(aux)
        x = jnp.asarray(data[f"x{s}"])
        dense, _ = moe.routed_dense(x.reshape(-1, cfg.d_model), p, cfg)
        out[f"{tag}_dense"] = np.asarray(dense).reshape(x.shape)
np.savez(sys.argv[2], **out)
"""

RANK = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                        rank=rank, world_size=world)
from repro_torch.configs import get_config
from repro_torch.device import set_device
from repro_torch.distributed.sharding import make_context
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.models import convert, moe
set_device("cpu")
data = np.load(sys.argv[4])
cfg = dataclasses.replace(get_config(sys.argv[6]), dtype="float32")
full = {k: torch.from_numpy(data[k]) for k in ("router", "w1", "w3", "w2")}
out = {}
for D, M in json.loads(sys.argv[7]):
    if D * M != world:
        continue
    mesh = make_host_mesh(D, M)
    ctx = make_context(mesh)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    assert (d, m) == divmod(rank, M), (rank, d, m)
    p = moe.local_experts(full, ctx)
    El = cfg.num_experts // M
    assert torch.equal(p["w1"], full["w1"][m * El:(m + 1) * El])
    assert p["router"] is full["router"]
    tree = convert.local_expert_params({"layers": [{"ffn": full}]}, ctx)
    assert all(torch.equal(tree["layers"][0]["ffn"][k], p[k]) for k in p)
    for s in json.loads(sys.argv[8]):
        x = torch.from_numpy(data[f"x{s}"])
        b = x.shape[0] // D
        with torch.no_grad():
            y, aux = moe.routed_ep(x[d * b:(d + 1) * b], p, cfg, ctx)
        tag = f"{D}x{M}_S{s}"
        out[f"{tag}_y"], out[f"{tag}_aux"] = y.numpy(), aux.numpy()
        out[f"{tag}_d"] = np.int64(d)
np.savez(sys.argv[5], **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``routed_ep`` on forced host devices and the port's
    on spawned gloo ranks, all started together, on the same numpy
    inputs: ``(reference results, [each rank's results by world])``."""
    tmp = tmp_path_factory.mktemp("ep_ranks")
    _, cfg = _cfgs("float32")
    rng = np.random.RandomState(7)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    data = {"router": rng.randn(d, E) / np.sqrt(d),
            "w1": rng.randn(E, d, ff) / np.sqrt(d),
            "w3": rng.randn(E, d, ff) / np.sqrt(d),
            "w2": rng.randn(E, ff, d) / np.sqrt(ff)}
    for s in RANK_SEQS:
        data[f"x{s}"] = 0.5 * rng.randn(RANK_B, s, d)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{k: v.astype(np.float32) for k, v in data.items()})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    meshes, seqs = json.dumps(MESHES), json.dumps(RANK_SEQS)
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(tmp / "ref.npz"),
         ARCH, meshes, seqs], env=env, cwd=tmp, stderr=subprocess.PIPE,
        text=True)]
    outs = []
    for world in sorted({D * M for D, M in MESHES}):
        store = tmp / f"store{world}"
        for rank in range(world):
            outs.append(tmp / f"rank{world}_{rank}.npz")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, str(rank), str(world),
                 str(store), str(inputs), str(outs[-1]), ARCH, meshes,
                 seqs], env=env, cwd=tmp, stderr=subprocess.PIPE,
                text=True))
    try:
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "ref.npz")), [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seq", RANK_SEQS, ids=lambda s: f"S{s}")
def test_ep_across_ranks_matches_the_reference(ranks, shape, seq):
    """Every rank's ``y`` equals the reference's rows of its data shard;
    with one data shard ``aux`` equals the reference's, which is then
    the model-axis mean by definition."""
    ref, per_rank = ranks
    D, M = shape
    tag = f"{D}x{M}_S{seq}"
    got = [r for r in per_rank if f"{tag}_y" in r]
    assert len(got) == D * M
    b = RANK_B // D
    want = ref[f"{tag}_y"]
    for r in got:
        d = int(r[f"{tag}_d"])
        np.testing.assert_allclose(r[f"{tag}_y"], want[d * b:(d + 1) * b],
                                   rtol=1e-5, atol=1e-5)
        if D == 1:
            np.testing.assert_allclose(r[f"{tag}_aux"], ref[f"{tag}_aux"],
                                       rtol=0, atol=1e-6)
    # a capacity of 1.25 drops pairs in the sequence-sharded cases: the
    # drop-free route is far from them
    if seq > 1:
        assert np.abs(ref[f"{tag}_dense"] - want).max() > 0.1
