"""The port's MoE family against the reference at ``deepseek-moe-16b-smoke``
(4 layers: 1 dense of d_ff 128, then 3 MoE of 8 experts, top-2, 1
shared expert of 32; d 64, 4 heads over 2 KV heads, head_dim 16) on the
CPU.

Inputs come from numpy seeds; the reference's parameters
(``repro.models.model.init``) reach the port through
``import_reference_params``. Tolerances: routing indices equal exactly;
``moe_block`` in float32 to 1e-5 and in bfloat16 to rtol=atol=0.05
(tests/test_models.py's bound for the MoE block); logits in float32 to
``TOL32`` = 1e-4 and generated ids equal; ``lm_loss``'s ce, aux and loss
to 1e-5; the port's prefill + decode against its own forward within
0.02 relative (tests/test_models.py's serve-path bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.models import moe as JMOE
from repro.serve import engine as jengine
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import use_device
from repro_torch.models import convert, layers as L, model, moe
from repro_torch.serve import engine

ARCH = "deepseek-moe-16b-smoke"
CHUNK = 8                        # several q and KV blocks at S = 16
JCTX = JL.ModelContext(remat="none", q_chunk=CHUNK, k_chunk=CHUNK)
CTX = L.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK)
B, S, NEW = 2, 16, 6
TOL32 = 1e-4
TOL_BLOCK = {"float32": 1e-5, "bfloat16": 0.05}


def _cfgs(dtype):
    return (dataclasses.replace(jget_config(ARCH), dtype=dtype),
            dataclasses.replace(get_config(ARCH), dtype=dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, convert.to_tensor(j)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


class Model:
    def __init__(self, dtype):
        self.jcfg, self.cfg = _cfgs(dtype)
        self.jparams = jax.jit(jmodel.init, static_argnums=1)(
            jax.random.PRNGKey(1), self.jcfg)
        self.params = convert.import_reference_params(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        rng = np.random.RandomState(5)
        self.tokens_np = rng.randint(0, self.cfg.vocab_size,
                                     (B, S + 1)).astype(np.int32)
        self.jtokens = jnp.asarray(self.tokens_np)
        self.tokens = torch.from_numpy(self.tokens_np.astype(np.int64))

    def moe_layer(self, r=0):
        """(reference, port) parameters of the r-th MoE layer's FFN."""
        jp = jax.tree_util.tree_map(lambda a: a[r],
                                    self.jparams["stage1"]["layer0"]["ffn"])
        return jp, self.params["layers"][1 + r]["ffn"]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    return Model(request.param)


@pytest.fixture(scope="module")
def lm32():
    return Model("float32")


def _x(cfg, seed, shape=(B, S)):
    return (0.5 * np.random.RandomState(seed).randn(*shape, cfg.d_model)
            ).astype(np.float32)


# ------------------------------------------------------------- the block
def test_route_indices_equal_the_references(lm):
    dtype = lm.cfg.dtype
    jp, tp = lm.moe_layer()
    jx, tx = _pair(_x(lm.cfg, 3, (B * S,)), dtype)
    k = lm.cfg.experts_per_token
    gates, idx, aux = moe.route(tx, tp["router"], k)
    jgates, jidx, jaux = jax.jit(JMOE._route, static_argnums=2)(
        jx, jp["router"], k)
    assert idx.shape == (B * S, k) and gates.dtype == tx.dtype
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, jgates, 1e-5 if dtype == "float32" else 1e-2)
    _close(aux, jaux, 1e-5)


def test_moe_block_matches_the_reference(lm):
    dtype = lm.cfg.dtype
    for r in range(lm.cfg.num_layers - 1):
        jp, tp = lm.moe_layer(r)
        jx, tx = _pair(_x(lm.cfg, 10 + r), dtype)
        y, aux = moe.moe_block(tp, tx, lm.cfg, CTX)
        jy, jaux = jax.jit(lambda p, x: JMOE.moe_block(
            p, x, lm.jcfg, JCTX))(jp, jx)
        assert y.dtype == tx.dtype and aux.dtype == torch.float32
        _close(y, jy, TOL_BLOCK[dtype])
        _close(aux, jaux, 1e-5)


def test_experts_that_get_no_token(lm32):
    """A router that never picks experts 5-7 (their logits sit ~50 below
    the others through feature 0) and favours expert 0: the idle experts
    run no matmul, and the block still equals the reference's."""
    cfg = lm32.cfg
    jp, tp = lm32.moe_layer()
    router = np.array(jp["router"])
    router[0, 5:] = -10.0
    router[0, 0] = 1.0
    x = _x(cfg, 4)
    x[..., 0] = 5.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    jx, tx = _pair(x, "float32")
    _, idx, _ = moe.route(tx.reshape(B * S, -1), tp["router"],
                          cfg.experts_per_token)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    assert counts[5:].sum() == 0 and counts[0] == B * S
    y, aux = moe.moe_block(tp, tx, cfg, CTX)
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_block(p, x, lm32.jcfg, JCTX))(
        jp, jx)
    _close(y, jy, 1e-5)
    _close(aux, jaux, 1e-5)


def test_routed_equals_every_expert_over_every_token(lm32):
    """The sorted per-expert combine against the oracle's own loop (every
    expert over every token, weighted where chosen), in the port."""
    cfg = lm32.cfg
    _, tp = lm32.moe_layer(1)
    xt = torch.from_numpy(_x(cfg, 6, (B * S,)))
    got, aux = moe.routed(xt, tp, cfg)
    gates, idx, want_aux = moe.route(xt, tp["router"], cfg.experts_per_token)
    want = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        w = torch.where(idx == e, gates, 0.0).sum(-1)
        want += L.swiglu(xt, tp["w1"][e], tp["w3"][e], tp["w2"][e]) * \
            w[:, None]
    _close(got, want, 1e-6)
    assert torch.equal(aux, want_aux)


# ------------------------------------------------------------- the model
def test_forward_and_lm_loss_match_the_reference(lm32):
    cfg, jcfg = lm32.cfg, lm32.jcfg
    hid, aux = model.forward(lm32.params, lm32.tokens[:, :S], cfg, CTX)
    jhid, jaux = jax.jit(lambda p, t: jmodel.forward(p, t, jcfg, JCTX))(
        lm32.jparams, lm32.jtokens[:, :S])
    _close(hid, jhid, TOL32)
    _close(aux, jaux, 1e-5)
    assert float(aux) > 0
    # remat recomputes each layer in the backward; the sum is the same
    rhid, raux = model.forward(lm32.params, lm32.tokens[:, :S], cfg,
                               dataclasses.replace(CTX, remat="full"))
    assert torch.equal(rhid, hid) and torch.equal(raux, aux)

    loss, metrics = model.lm_loss(lm32.params, {"tokens": lm32.tokens}, cfg,
                                  CTX)
    jloss, jmetrics = jax.jit(lambda p, t: jmodel.lm_loss(
        p, {"tokens": t}, jcfg, JCTX))(lm32.jparams, lm32.jtokens)
    for key in ("ce", "aux", "loss"):
        _close(metrics[key], jmetrics[key], 1e-5)
    _close(loss, jloss, 1e-5)
    assert torch.equal(metrics["loss"], metrics["ce"] + 0.001 *
                       metrics["aux"])


def test_prefill_and_decode_match_the_reference(lm32):
    cfg, jcfg = lm32.cfg, lm32.jcfg
    cache_len = S + 4
    caches, logits = model.prefill(lm32.params, lm32.tokens[:, :S], cfg, CTX,
                                   cache_len=cache_len)
    jcaches, jlogits = jax.jit(lambda p, t: jmodel.prefill(
        p, t, jcfg, JCTX, cache_len=cache_len))(lm32.jparams,
                                                lm32.jtokens[:, :S])
    assert logits.shape == (B, cfg.padded_vocab_size)
    _close(logits, jlogits, TOL32)
    jlayers = [(jcaches[f"stage{si}"]["layer0"], r)
               for si, st in enumerate(cfg.plan()) for r in range(st.repeat)]
    assert len(caches) == len(jlayers) == cfg.num_layers
    for (k, v), ((jk, jv), r) in zip(caches, jlayers):
        _close(k, jk[r], TOL32)
        _close(v, jv[r], TOL32)
    _, dec = model.decode_step(lm32.params, caches,
                               lm32.tokens[:, S:S + 1], S, cfg, CTX)
    _, jdec = jax.jit(lambda p, c, t: jmodel.decode_step(
        p, c, t, jnp.int32(S), jcfg, JCTX))(lm32.jparams, jcaches,
                                            lm32.jtokens[:, S:S + 1])
    _close(dec, jdec, TOL32)


def test_generate_matches_the_reference(lm32):
    with use_device("cpu"):
        got = engine.generate(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX,
                              max_new_tokens=NEW)
    want = jengine.generate(lm32.jparams, lm32.jtokens[:, :S], lm32.jcfg,
                            JCTX, max_new_tokens=NEW)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_matches_forward():
    """tests/test_models.py's serve-path check at the MoE config (bf16,
    the port's own random init)."""
    cfg = get_config(ARCH)
    params = model.init(torch.Generator().manual_seed(1), cfg)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S + 1)))
    hid, _ = model.forward(params, tokens, cfg, CTX)
    ref = (hid[:, -1] @ params["unembed"]).float()
    caches, _ = model.prefill(params, tokens[:, :S], cfg, CTX,
                              cache_len=S + 4)
    _, dec = model.decode_step(params, caches, tokens[:, S:S + 1], S, cfg,
                               CTX)
    rel = (dec - ref).abs().max() / (ref.abs().max() + 1e-6)
    assert rel < 0.02


# ---------------------------------------------------- init and conversion
def test_init_uses_the_reference_scales_and_dtypes():
    cfg = dataclasses.replace(get_config(ARCH), num_experts=64)
    p = model.init(torch.Generator().manual_seed(0), cfg)
    d, ff = cfg.d_model, cfg.moe_d_ff
    assert len(p["layers"]) == cfg.num_layers
    dense = p["layers"][0]["ffn"]
    assert dense["w1"].shape == (d, cfg.dense_d_ff) and \
        dense["w1"].dtype == torch.bfloat16
    for layer in p["layers"][1:]:
        f = layer["ffn"]
        assert f["router"].dtype == torch.float32
        assert f["router"].shape == (d, cfg.num_experts)
        shapes = {"w1": (cfg.num_experts, d, ff), "w3": (cfg.num_experts, d,
                                                          ff),
                  "w2": (cfg.num_experts, ff, d), "ln": (d,),
                  "sh_w1": (d, ff), "sh_w3": (d, ff), "sh_w2": (ff, d)}
        assert {k: tuple(t.shape) for k, t in f.items() if k != "router"} \
            == shapes
        assert all(f[k].dtype == torch.bfloat16 for k in shapes)
        assert not f["ln"].any()
        for name, fan_in in (("router", d), ("w1", d), ("w3", d),
                             ("w2", ff), ("sh_w1", d), ("sh_w2", ff)):
            assert abs(f[name].float().std().item() * fan_in ** 0.5 - 1) \
                < 0.1, name
    meta = model.init(L.ShapesOnly(), cfg)
    assert all(t.is_meta for t in tree.flatten_with_names(meta).values())
    assert meta["layers"][1]["ffn"]["router"].dtype == torch.float32


def test_convert_round_trip_is_bit_for_bit_over_both_stages(lm):
    jflat = tree.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, lm.jparams))
    assert any(n.startswith("stage1/") for n in jflat)
    for layer in lm.params["layers"][1:]:
        assert layer["ffn"]["router"].dtype == torch.float32
        assert layer["ffn"]["w1"].dtype == getattr(torch, lm.cfg.dtype)
    back = tree.flatten_with_names(
        convert.export_reference_params(lm.params, lm.cfg))
    assert back.keys() == jflat.keys()
    for name, want in jflat.items():
        np.testing.assert_array_equal(back[name],
                                      want.astype(np.float32), name)
