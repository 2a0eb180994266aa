"""The port's LM serving path against the reference at ``qwen2-7b-smoke``
(4 layers, d 64, 4 heads over 2 KV heads, head_dim 16) on the CPU.

Inputs come from numpy seeds; the reference's parameters
(``repro.models.model.init``) reach the port through
``import_reference_params``. Tolerances: float32 (the config with
``dtype="float32"``), logits within rtol=atol=1e-4 and generated ids
equal; bfloat16, relative logit error < 0.02, the bound
tests/test_models.py states for qwen2. Layers are held at 1e-5 in
float32 (one op each) and at the bf16 rounding step in bfloat16.
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
from repro_torch.configs import get_config
from repro_torch.device import use_device
from repro_torch.kernels import ops
from repro_torch.models import convert, layers as L, model
from repro_torch.serve import engine

ARCH = "qwen2-7b-smoke"
CHUNK = 8                        # several q and KV blocks at S = 16
JCTX = JL.ModelContext(remat="none", q_chunk=CHUNK, k_chunk=CHUNK)
CTX = L.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK)
B, S, NEW = 2, 16, 6
TOL32 = 1e-4
REL_BF16 = 0.02


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


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


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


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    return Model(request.param)


@pytest.fixture(scope="module")
def lm32():
    return Model("float32")


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL32,
                                   atol=TOL32)
    else:
        assert _rel(got, want) < REL_BF16


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    scale = (0.1 * rng.randn(16)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    js, ts = _pair(scale, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(L.rms_norm(tx, ts)),
                               _np(JL.rms_norm(jx, js)), rtol=tol, atol=tol)
    pos = np.arange(7)[None, :] + 3
    got = L.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = JL.apply_rope(jx, jnp.asarray(pos), 1e6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


ATTN_CASES = {
    # causal prefill: the flash kernel's case on the card
    "causal": dict(sq=16, skv=16, kw=dict(causal=True)),
    "causal_skip": dict(sq=16, skv=16, kw=dict(causal=True,
                                               skip_noncausal=True)),
    "window": dict(sq=16, skv=16, kw=dict(causal=True, window=5)),
    "kv_len": dict(sq=16, skv=24, kw=dict(causal=False, kv_len=13)),
    "decode": dict(sq=1, skv=24, kw=dict(causal=False, kv_len=10)),
    "decode_window": dict(sq=1, skv=24, kw=dict(causal=False, kv_len=20,
                                                window=6)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference(case, dtype):
    c = ATTN_CASES[case]
    rng = np.random.RandomState(len(case))
    q = rng.randn(2, c["sq"], 4, 16).astype(np.float32)
    k = rng.randn(2, c["skv"], 2, 16).astype(np.float32)
    v = rng.randn(2, c["skv"], 2, 16).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = L.attention(tq, tk, tv, q_chunk=CHUNK, k_chunk=CHUNK, **c["kw"])
    jkw = dict(c["kw"])
    if "kv_len" in jkw:
        jkw["kv_len"] = jnp.int32(jkw["kv_len"])
    want = JL.attention(jq, jk, jv, q_chunk=CHUNK, k_chunk=CHUNK, **jkw)
    assert got.dtype == tv.dtype and got.shape == tuple(want.shape)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_attention_on_the_cpu_never_launches_the_kernel():
    ops.reset_launches()
    x = torch.randn(1, 16, 4, 16)
    L.attention(x, x[:, :, :2].contiguous(), x[:, :, :2].contiguous())
    assert ops.LAUNCHES["flash_attention"] == 0


def test_attn_and_ffn_blocks_match_reference(lm):
    dtype = lm.cfg.dtype
    rng = np.random.RandomState(2)
    x = (0.5 * rng.randn(B, S, lm.cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jp = jax.tree_util.tree_map(lambda a: a[0], lm.jparams["stage0"]["layer0"])
    tp = lm.params["layers"][0]
    got, (tk, tv) = L.attn_block(tp["attn"], tx, lm.cfg, CTX, return_kv=True)
    want, (jk, jv) = jax.jit(lambda p, x: JL.attn_block(
        p, x, lm.jcfg, JCTX, return_kv=True))(jp["attn"], jx)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        _check(g, w, dtype)
    _check(L.ffn_block(tp["ffn"], tx, lm.cfg),
           jax.jit(lambda p, x: JL.ffn_block(p, x, lm.jcfg, JCTX))(
               jp["ffn"], jx), dtype)

    # decode mode: one row written into the cache at position 9
    cache_np = (0.3 * rng.randn(B, 12, 2, 16)).astype(np.float32)
    (jkc, tkc), (jvc, tvc) = _pair(cache_np, dtype), _pair(cache_np, dtype)
    pos = np.full((B, 1), 9)
    got, (ok, ov) = L.attn_block(tp["attn"], tx[:, :1], lm.cfg, CTX,
                                 positions=torch.from_numpy(pos),
                                 cache=(tkc, tvc), cache_pos=9)
    want, (wk, wv) = jax.jit(lambda p, x, c: JL.attn_block(
        p, x, lm.jcfg, JCTX, positions=jnp.asarray(pos), cache=c,
        cache_pos=jnp.int32(9)))(jp["attn"], jx[:, :1], (jkc, jvc))
    assert ok is tkc                   # written in place
    for g, w in ((got, want), (ok, wk), (ov, wv)):
        _check(g, w, dtype)


# ------------------------------------------------------------------ model
def test_prefill_and_decode_match_reference(lm):
    dtype = lm.cfg.dtype
    cache_len = S + 4
    prompt, nxt = lm.tokens[:, :S], lm.tokens[:, S:S + 1]
    caches, logits = model.prefill(lm.params, prompt, lm.cfg, CTX,
                                   cache_len=cache_len)
    jcaches, jlogits = jax.jit(lambda p, t: jmodel.prefill(
        p, t, lm.jcfg, JCTX, cache_len=cache_len))(lm.jparams,
                                                   lm.jtokens[:, :S])
    assert logits.dtype == torch.float32
    assert logits.shape == (B, lm.cfg.padded_vocab_size)
    _check(logits, jlogits, dtype)
    jk, jv = jcaches["stage0"]["layer0"]
    for i, (k, v) in enumerate(caches):
        assert k.shape == (B, cache_len, 2, 16) and k.dtype == lm.params[
            "embed"].dtype
        _check(k, jk[i], dtype)
        _check(v, jv[i], dtype)
        assert not k[:, S:].any() and not v[:, S:].any()

    caches, dec = model.decode_step(lm.params, caches, nxt, S, lm.cfg, CTX)
    _, jdec = jax.jit(lambda p, c, t: jmodel.decode_step(
        p, c, t, jnp.int32(S), lm.jcfg, JCTX))(lm.jparams, jcaches,
                                               lm.jtokens[:, S:S + 1])
    _check(dec, jdec, dtype)


def test_generate_matches_reference(lm32):
    with use_device("cpu"):
        got = engine.generate(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX,
                              max_new_tokens=NEW)
    want = jengine.generate(lm32.jparams, lm32.jtokens[:, :S], lm32.jcfg,
                            JCTX, max_new_tokens=NEW)
    assert got.shape == (B, NEW) and got.dtype == lm32.tokens.dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_matches_forward():
    """The port's counterpart of tests/test_models.py's serve-path check
    at qwen2 (bf16, the port's own random init)."""
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
    assert _rel(dec, ref) < 0.02


def test_sampling_draws_from_the_generator(lm32):
    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with use_device("cpu"):
            return engine.generate(lm32.params, lm32.tokens[:, :S], lm32.cfg,
                                   CTX, max_new_tokens=NEW, greedy=False,
                                   generator=gen)
    a, b = run(3), run(3)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < lm32.cfg.padded_vocab_size


def test_init_uses_the_reference_scales():
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    p = model.init(torch.Generator().manual_seed(0), cfg)
    d = cfg.d_model
    assert len(p["layers"]) == cfg.num_layers
    assert p["embed"].shape == (cfg.padded_vocab_size, d)
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    assert abs(p["unembed"].std().item() - d ** -0.5) < 0.01
    a = p["layers"][0]["attn"]
    assert abs(a["wo"].std().item() - (cfg.num_heads * 16) ** -0.5) < 0.02
    assert not a["bq"].any() and not a["ln"].any()
    assert not p["final_ln"].any()


@pytest.mark.parametrize("change, word", [
    (dict(family="vlm", cross_attn_every=2, num_image_tokens=8), "vlm"),
    (dict(family="moe", use_mla=True), "use_mla=True"),
])
def test_other_families_raise_naming_the_family(change, word):
    """The VLM family and MLA (with MTP) run: their smoke configs, which
    carry ``change``, init with their own leaves (tests/test_torch_vlm.py
    and tests/test_torch_mla.py hold them to the reference). A family the
    reference does not have still raises, naming it."""
    arch = {"vlm": "llama-3.2-vision-90b-smoke",
            "use_mla=True": "deepseek-v3-671b-smoke"}[word]
    cfg = get_config(arch)
    assert {k: getattr(cfg, k) for k in change} == change
    p = model.init(torch.Generator(), cfg)
    leaf = "gate" if cfg.family == "vlm" else "wkv_a"
    assert any(leaf in layer["attn"] for layer in p["layers"])
    with pytest.raises(NotImplementedError, match="'vision'"):
        model.init(torch.Generator(),
                   dataclasses.replace(cfg, family="vision"))


def test_generate_without_a_card_raises(monkeypatch, lm32):
    from repro_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        engine.generate(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX,
                        max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        model.init_cache(lm32.cfg, B, S)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32"])
def test_convert_keeps_dtype_and_bits(dtype):
    a = jnp.asarray(np.random.RandomState(0).randn(3, 5) * 100).astype(dtype)
    t = convert.to_tensor(np.asarray(a))
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        t.view(torch.int16 if dtype == "bfloat16" else t.dtype).numpy(),
        np.asarray(a).view(np.int16 if dtype == "bfloat16" else a.dtype))


def test_imported_params_are_the_reference_params(lm):
    jp = lm.jparams["stage0"]["layer0"]
    for i, layer in enumerate(lm.params["layers"]):
        for part in ("attn", "ffn"):
            assert set(layer[part]) == set(jp[part])
            for name, t in layer[part].items():
                np.testing.assert_array_equal(_np(t), _np(jp[part][name][i]))
    np.testing.assert_array_equal(_np(lm.params["embed"]),
                                  _np(lm.jparams["embed"]))


def test_stepwise_decode_from_an_empty_cache_matches_forward(lm32):
    """init_cache + one decode_step per token gives the teacher-forced
    forward's last logits (float32)."""
    cfg, T = lm32.cfg, 10
    tokens = lm32.tokens[:1, :T]
    hid, _ = model.forward(lm32.params, tokens, cfg, CTX)
    want = (hid[:, -1] @ lm32.params["unembed"]).float()
    caches = model.init_cache(cfg, 1, T + 2, device="cpu")
    for t in range(T):
        caches, logits = model.decode_step(lm32.params, caches,
                                           tokens[:, t:t + 1], t, cfg, CTX)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=TOL32,
                               atol=TOL32)
