"""The port's MLA attention and MTP head (``deepseek-v3-671b``) against the
reference at ``deepseek-v3-671b-smoke`` on the CPU: 4 layers (1 dense of
d_ff 128, then 3 MoE of 8 experts, top-2, 1 shared expert of 32), MLA
with q and kv ranks 32, nope/rope/v head dims 16/8/16, 4 heads, d 64,
and one MTP module (GQA attention, 4 heads of 16 over 2 KV heads, and a
dense FFN of 128).

Inputs come from numpy seeds; the reference's parameters reach the port
through ``import_reference_params``. Tolerances: ``mla_block`` (prefill
output, raw latent caches, absorbed decode) in float32 to 1e-5 and in
bfloat16 to rtol=atol=0.05; losses (``ce``, ``mtp``, ``aux``, ``loss``)
in float32 to 1e-5 and bfloat16 to 0.05; logits in float32 to 1e-4 and
in bfloat16 to 0.05 of the largest |logit| (tests/test_torch_moe.py,
tests/test_torch_local_global.py), and the final hidden states the same
way (in bfloat16 the two packages' expert products part by a bf16 step
a layer, and after three MoE layers one element of 2,048 differs by
0.065 at |hidden| ~2); float32 generated ids equal; every float32
gradient leaf of ``lm_loss`` to 1e-4 of its largest |value| (its
``jax.grad``). The absorbed decode against the port's own
teacher-forced forward: 0.02 relative in float32 and the reference's
0.08 in bfloat16 (tests/test_models.py's MLA bound).
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
from repro.serve import engine as jengine
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import use_device
from repro_torch.models import convert, layers as L, model
from repro_torch.serve import engine
from repro_torch.train import OptimizerConfig
from repro_torch.train import train_step as ts

ARCH = "deepseek-v3-671b-smoke"
CHUNK = 8                        # several q and KV blocks at S = 16
JCTX = JL.ModelContext(remat="none", q_chunk=CHUNK, k_chunk=CHUNK)
CTX = L.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK)
B, S, NEW, STEPS = 2, 16, 6, 4
TOL = {"float32": 1e-5, "bfloat16": 0.05}
TOL32_LOGITS = 1e-4
LOGITS_BF16_REL = 0.05
GRAD_TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_logits(got, want, dtype):
    if dtype == "float32":
        _close(got, want, TOL32_LOGITS)
        return
    got, want = _np(got), _np(want)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < LOGITS_BF16_REL, rel


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, convert.to_tensor(np.asarray(j))


class Model:
    def __init__(self, dtype):
        self.dtype = dtype
        self.jcfg = dataclasses.replace(jget_config(ARCH), dtype=dtype)
        self.cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
        self.jparams = jax.jit(jmodel.init, static_argnums=1)(
            jax.random.PRNGKey(1), self.jcfg)
        self.params = convert.import_reference_params(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        rng = np.random.RandomState(5)
        self.tokens_np = rng.randint(0, self.cfg.vocab_size,
                                     (B, S + STEPS + 1)).astype(np.int32)
        self.jtokens = jnp.asarray(self.tokens_np)
        self.tokens = torch.from_numpy(self.tokens_np.astype(np.int64))

    def mla(self, li):
        """(reference, port) MLA leaves of layer ``li`` (0 is dense)."""
        si, r = (0, 0) if li == 0 else (1, li - 1)
        jp = jax.tree_util.tree_map(
            lambda a: a[r], self.jparams[f"stage{si}"]["layer0"]["attn"])
        return jp, self.params["layers"][li]["attn"]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    return Model(request.param)


@pytest.fixture(scope="module")
def lm32():
    return Model("float32")


def _x(cfg, seed, s=S):
    return (0.5 * np.random.RandomState(seed).randn(B, s, cfg.d_model)
            ).astype(np.float32)


# ------------------------------------------------------------- the plan
def test_plan_is_mla_dense_then_mla_moe_with_mtp():
    cfg = get_config(ARCH)
    specs = model.layer_specs(cfg)
    assert [(s.kind, s.ffn) for s in specs] == \
        [("mla", "dense")] + [("mla", "moe")] * 3
    full = get_config("deepseek-v3-671b")
    assert [(st.repeat, st.layers[0].kind, st.layers[0].ffn)
            for st in full.plan()] == [(3, "mla", "dense"),
                                       (58, "mla", "moe")]
    assert model.MTP_SPEC.kind == "attn" and full.mtp_depth == 1


def test_init_shapes_dtypes_and_mtp():
    cfg = get_config(ARCH)
    p = model.init(torch.Generator().manual_seed(0), cfg)
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    want = {"wq_a": (d, qr), "q_ln": (qr,), "wq_b": (qr, h * (dn + dr)),
            "wkv_a": (d, kvr + dr), "kv_ln": (kvr,), "wk_b": (kvr, h * dn),
            "wv_b": (kvr, h * dv), "wo": (h * dv, d), "ln": (d,)}
    assert len(p["layers"]) == cfg.num_layers
    for layer in p["layers"]:
        a = layer["attn"]
        assert {k: tuple(t.shape) for k, t in a.items()} == want
        assert all(t.dtype == torch.bfloat16 for t in a.values())
        assert not a["q_ln"].any() and not a["kv_ln"].any()
        for name in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
            fan_in = a[name].shape[0]
            assert abs(a[name].float().std().item() * fan_in ** 0.5 - 1) \
                < 0.15, name
    assert p["layers"][0]["ffn"]["w1"].shape == (d, cfg.dense_d_ff)
    mtp = p["mtp"]
    assert set(mtp) == {"proj", "ln_h", "ln_e", "attn", "ffn"}
    assert mtp["proj"].shape == (2 * d, d)
    assert abs(mtp["proj"].float().std().item() * (2 * d) ** 0.5 - 1) < 0.1
    assert mtp["attn"]["wq"].shape == (d, h * cfg.head_dim)
    assert mtp["attn"]["wk"].shape == (d, cfg.num_kv_heads * cfg.head_dim)
    assert mtp["ffn"]["w1"].shape == (d, cfg.dense_d_ff)
    meta = model.init(L.ShapesOnly(), cfg)
    assert all(t.is_meta for t in tree.flatten_with_names(meta).values())
    assert "mtp" in meta
    no_mtp = model.init(torch.Generator().manual_seed(0),
                        dataclasses.replace(cfg, mtp_depth=0))
    assert "mtp" not in no_mtp


def test_latent_cache_shapes():
    cfg = get_config(ARCH)
    with use_device("cpu"):
        caches = model.init_cache(cfg, B, 20)
    assert [tuple(t.shape) for c in caches for t in c] == \
        [(B, 20, cfg.kv_lora_rank), (B, 20, cfg.qk_rope_head_dim)] * 4
    # 1,152 bytes a token and layer at full width in bf16
    full = get_config("deepseek-v3-671b")
    assert 2 * (full.kv_lora_rank + full.qk_rope_head_dim) == 1152


# ------------------------------------------------------------- the block
@pytest.mark.parametrize("li", [0, 2])
def test_mla_block_prefill_matches_the_reference(lm, li):
    jp, tp = lm.mla(li)
    jx, tx = _pair(_x(lm.cfg, 10 + li), lm.dtype)
    y, (c_kv, k_pe) = L.mla_block(tp, tx, lm.cfg, CTX, return_kv=True)
    jy, (jc, jpe) = jax.jit(lambda p, x: JL.mla_block(
        p, x, lm.jcfg, JCTX, return_kv=True))(jp, jx)
    assert y.dtype == tx.dtype
    assert tuple(c_kv.shape) == (B, S, lm.cfg.kv_lora_rank)
    assert tuple(k_pe.shape) == (B, S, lm.cfg.qk_rope_head_dim)
    _close(y, jy, TOL[lm.dtype])
    _close(c_kv, jc, TOL[lm.dtype])
    _close(k_pe, jpe, TOL[lm.dtype])


@pytest.mark.parametrize("li", [0, 3])
def test_mla_block_absorbed_decode_matches_the_reference(lm, li):
    """One decode row against a latent cache of 20 rows, 16 of them
    written (seeded values), at position 16: the new row is written in
    place and the latent attention equals the reference's."""
    cfg = lm.cfg
    jp, tp = lm.mla(li)
    rng = np.random.RandomState(20 + li)
    c = np.zeros((B, 20, cfg.kv_lora_rank), np.float32)
    pe = np.zeros((B, 20, cfg.qk_rope_head_dim), np.float32)
    c[:, :S] = rng.randn(B, S, cfg.kv_lora_rank)
    pe[:, :S] = rng.randn(B, S, cfg.qk_rope_head_dim)
    (jc, tc), (jpe, tpe) = _pair(c, lm.dtype), _pair(pe, lm.dtype)
    jx, tx = _pair(_x(cfg, 30 + li, 1), lm.dtype)
    pos = torch.full((B, 1), S)
    y, (nc, npe) = L.mla_block(tp, tx, cfg, CTX, positions=pos,
                               cache=(tc, tpe), cache_pos=S)
    assert nc is tc and npe is tpe                  # written in place
    jy, (jnc, jnpe) = jax.jit(lambda p, x, c, e: JL.mla_block(
        p, x, lm.jcfg, JCTX, positions=jnp.full((B, 1), S),
        cache=(c, e), cache_pos=jnp.int32(S)))(jp, jx, jc, jpe)
    _close(y, jy, TOL[lm.dtype])
    _close(nc, jnc, TOL[lm.dtype])
    _close(npe, jnpe, TOL[lm.dtype])
    assert not nc[:, S + 1:].any()


def test_absorbed_decode_equals_the_expanded_attention(lm32):
    """The latent identity, in the port alone: decoding row t of a
    sequence against its first t latent rows gives the prefill's output
    at row t (q absorbed through wk_b, the output through wv_b)."""
    cfg = lm32.cfg
    _, tp = lm32.mla(1)
    x = torch.from_numpy(_x(cfg, 40, S + 1))
    full, (c_kv, k_pe) = L.mla_block(tp, x, cfg, CTX, return_kv=True)
    cache = (torch.zeros(B, S + 4, cfg.kv_lora_rank),
             torch.zeros(B, S + 4, cfg.qk_rope_head_dim))
    cache[0][:, :S] = c_kv[:, :S]
    cache[1][:, :S] = k_pe[:, :S]
    y, _ = L.mla_block(tp, x[:, S:], cfg, CTX, positions=torch.full(
        (B, 1), S), cache=cache, cache_pos=S)
    _close(y, full[:, S:], 1e-5)


# ------------------------------------------------------------- the model
def test_forward_and_lm_loss_with_mtp_match_the_reference(lm):
    cfg, jcfg = lm.cfg, lm.jcfg
    tol = TOL[lm.dtype]
    hid, aux = model.forward(lm.params, lm.tokens[:, :S], cfg, CTX)
    jhid, jaux = jax.jit(lambda p, t: jmodel.forward(p, t, jcfg, JCTX))(
        lm.jparams, lm.jtokens[:, :S])
    # bf16: relative to the largest |value|, as the logits (module
    # docstring); elementwise one of 2,048 elements parts by 0.065
    _close_logits(hid, jhid, lm.dtype)
    _close(aux, jaux, tol)
    batch = {"tokens": lm.tokens[:, :S + 1]}
    loss, metrics = model.lm_loss(lm.params, batch, cfg, CTX)
    jloss, jmetrics = jax.jit(lambda p, t: jmodel.lm_loss(
        p, {"tokens": t}, jcfg, JCTX))(lm.jparams, lm.jtokens[:, :S + 1])
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "mtp", "loss"}
    for key in ("ce", "aux", "mtp", "loss"):
        want = float(jmetrics[key])
        assert abs(metrics[key].item() - want) <= tol * abs(want), key
    assert abs(loss.item() - float(jloss)) <= tol * abs(float(jloss))
    assert torch.equal(metrics["loss"], metrics["ce"] + 0.3 *
                       metrics["mtp"] + 0.001 * metrics["aux"])


def test_mtp_loss_is_the_references_head(lm32):
    """The MTP term alone: the reference's MTP module (norms, projection,
    one GQA layer, the unembedding) on the port's hidden states, recomputed
    here from its pieces, equals ``lm_loss``'s ``mtp``; without ``mtp``
    in the parameters there is no MTP term, as in the reference."""
    cfg = lm32.cfg
    toks = lm32.tokens[:, :S + 1]
    _, metrics = model.lm_loss(lm32.params, {"tokens": toks}, cfg, CTX)
    hidden, _ = model.forward(lm32.params, toks[:, :-1], cfg, CTX)
    p = lm32.params["mtp"]
    h = L.rms_norm(hidden[:, :-1], p["ln_h"], cfg.norm_eps)
    e = L.rms_norm(lm32.params["embed"][toks[:, 1:-1]], p["ln_e"],
                   cfg.norm_eps)
    hm = torch.cat([h, e], dim=-1) @ p["proj"]
    hm, _ = L.attn_block(p["attn"], hm, cfg, CTX)
    hm = L.ffn_block(p["ffn"], hm, cfg)
    want = model.fused_ce(hm, lm32.params["unembed"], toks[:, 2:],
                          cfg.vocab_size)
    assert torch.equal(metrics["mtp"], want)
    bare = {k: v for k, v in lm32.params.items() if k != "mtp"}
    _, m2 = model.lm_loss(bare, {"tokens": toks}, cfg, CTX)
    jbare = {k: v for k, v in lm32.jparams.items() if k != "mtp"}
    _, jm2 = jmodel.lm_loss(jbare, {"tokens": lm32.jtokens[:, :S + 1]},
                            lm32.jcfg, JCTX)
    assert set(m2) == set(jm2) == {"ce", "aux", "loss"}


def test_prefill_caches_and_decode_match_the_reference(lm):
    cfg, jcfg = lm.cfg, lm.jcfg
    cache_len = S + STEPS
    caches, logits = model.prefill(lm.params, lm.tokens[:, :S], cfg, CTX,
                                   cache_len=cache_len)
    jcaches, jlogits = jax.jit(lambda p, t: jmodel.prefill(
        p, t, jcfg, JCTX, cache_len=cache_len))(lm.jparams,
                                                lm.jtokens[:, :S])
    assert logits.shape == (B, cfg.padded_vocab_size)
    _close_logits(logits, jlogits, lm.dtype)
    jlayers = [(jcaches[f"stage{si}"]["layer0"], r)
               for si, st in enumerate(cfg.plan()) for r in range(st.repeat)]
    assert len(caches) == len(jlayers) == cfg.num_layers
    for (c, pe), ((jc, jpe), r) in zip(caches, jlayers):
        assert tuple(c.shape) == (B, cache_len, cfg.kv_lora_rank)
        assert tuple(pe.shape) == (B, cache_len, cfg.qk_rope_head_dim)
        _close(c, jc[r], TOL[lm.dtype])
        _close(pe, jpe[r], TOL[lm.dtype])
    jdec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, c, t, pos, jcfg, JCTX))
    for t in range(S, S + STEPS):
        caches, dec = model.decode_step(lm.params, caches,
                                        lm.tokens[:, t:t + 1], t, cfg, CTX)
        jcaches, jlog = jdec(lm.jparams, jcaches, lm.jtokens[:, t:t + 1],
                             jnp.int32(t))
        _close_logits(dec, jlog, lm.dtype)


def test_generate_matches_the_reference(lm32):
    """float32, as tests/test_torch_moe.py: in bfloat16 the ids part at
    the third new token of row 0, where the last MoE layer's router
    picks experts {0, 6} in the port and {0, 1} in the reference (a near
    tie under bf16 hidden states; the reference's top two logits there
    are one bf16 step apart)."""
    with use_device("cpu"):
        got = engine.generate(lm32.params, lm32.tokens[:, :S], lm32.cfg,
                              CTX, max_new_tokens=NEW)
    want = jengine.generate(lm32.jparams, lm32.jtokens[:, :S], lm32.jcfg,
                            JCTX, max_new_tokens=NEW)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype, tol", [("float32", 0.02),
                                        ("bfloat16", 0.08)])
def test_prefill_decode_matches_forward(dtype, tol):
    """tests/test_models.py's serve-path check at the MLA config (the
    port's own random init): the absorbed decode against the expanded
    teacher-forced forward."""
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
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
    assert rel < tol


# ---------------------------------------------- gradients and conversion
def test_lm_loss_gradient_with_mtp_matches_jax_grad(lm32):
    """Every float32 gradient leaf of ``lm_loss`` (MLA layers, experts,
    the MTP module) against ``jax.grad`` of the reference's, under
    remat."""
    jctx = dataclasses.replace(JCTX, remat="full")
    ctx = dataclasses.replace(CTX, remat="full")
    toks = lm32.tokens_np[:, :S + 1]
    (loss, metrics), grads = ts.loss_and_grads(
        lm32.params, {"tokens": torch.from_numpy(toks.astype(np.int64))},
        lm32.cfg, ctx)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jmodel.lm_loss(p, {"tokens": t}, lm32.jcfg, jctx),
        has_aux=True))(lm32.jparams, jnp.asarray(toks))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = tree.flatten_with_names(
        convert.export_reference_params(grads, lm32.cfg))
    want = tree.flatten_with_names(jax.tree_util.tree_map(_np, jgrads))
    assert list(got) == list(want)
    assert any(n.startswith("mtp/") for n in want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        rel = np.abs(got[name] - w).max() / np.abs(w).max()
        assert rel <= GRAD_TOL, (name, rel)


def test_train_step_runs_and_moves_every_part():
    """tests/test_models.py's per-arch smoke: one step, finite loss, the
    MLA layers and the MTP module moved and finite."""
    cfg = get_config(ARCH)
    state = ts.make_train_state(torch.Generator().manual_seed(0), cfg,
                                OptimizerConfig())
    step = ts.make_train_step(cfg, L.ModelContext(q_chunk=32, k_chunk=32),
                              OptimizerConfig())
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 25)))
    state2, metrics = step(state, {"tokens": tokens})
    assert np.isfinite(metrics["loss"].item()) and "mtp" in metrics
    before = tree.flatten_with_names(state["params"])
    after = tree.flatten_with_names(state2["params"])
    for name in ("layers/[0]/attn/wkv_a", "layers/[3]/attn/wk_b",
                 "mtp/proj", "mtp/attn/wq"):
        assert not torch.equal(before[name], after[name]), name
    assert all(torch.isfinite(t.float()).all() for t in after.values())


def test_convert_round_trip_is_bit_for_bit(lm):
    jflat = tree.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, lm.jparams))
    assert any(n.startswith("mtp/attn/") for n in jflat)
    assert lm.params["mtp"]["proj"].dtype == getattr(torch, lm.dtype)
    back = tree.flatten_with_names(
        convert.export_reference_params(lm.params, lm.cfg))
    assert back.keys() == jflat.keys()
    for name, want in jflat.items():
        np.testing.assert_array_equal(back[name],
                                      want.astype(np.float32), name)
