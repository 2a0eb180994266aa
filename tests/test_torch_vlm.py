"""The port's VLM family (``llama-3.2-vision-90b``: self-attention layers
with a cross-attention layer over image embeddings every
``cross_attn_every`` layers) against the reference at
``llama-3.2-vision-90b-smoke`` on the CPU: 2 super-blocks of one
self-attention layer and one cross-attention layer, 8 image tokens, d
64, 4 heads of 16 over 2 KV heads.

Inputs come from numpy seeds: the image embeddings are ``0.1 * normal``
(tests/test_models.py's), in the model dtype. The reference's parameters
reach the port through ``import_reference_params``; both packages
initialise a cross layer's ``gate`` at 0, where ``tanh(gate)`` switches
the layer off, so the fixture sets each gate to a seeded value in
[0.5, 1.5) in the reference's tree before importing it. Tolerances: the
attention block in float32 to 1e-5 and in bfloat16 to rtol=atol=0.05;
losses in float32 to 1e-5 and bfloat16 to 0.05; hidden states in
float32 to 1e-4 and in bfloat16 to rtol=atol=0.05; logits in float32 to
1e-4 and in bfloat16 to 0.05 of the largest |value|
(tests/test_torch_local_global.py); generated ids equal; every
float32 gradient leaf of ``lm_loss`` to 1e-4 of its largest |value|
(its ``jax.grad``); the port's prefill + decode against its own forward
within 0.02 relative (tests/test_models.py's serve-path bound).
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

ARCH = "llama-3.2-vision-90b-smoke"
CHUNK = 8                        # two q blocks at S = 16, one KV block of 8
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


def _close_rel(got, want, dtype):
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


def _image(cfg, seed=7, b=B):
    return (0.1 * np.random.RandomState(seed).randn(
        b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


class Model:
    def __init__(self, dtype):
        self.dtype = dtype
        self.jcfg = dataclasses.replace(jget_config(ARCH), dtype=dtype)
        self.cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
        jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                     self.jcfg)
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        gate = np_params["stage0"]["layer1"]["attn"]["gate"]
        assert gate.shape == (self.cfg.plan()[0].repeat,) and not gate.any()
        np_params["stage0"]["layer1"]["attn"]["gate"] = (
            0.5 + np.random.RandomState(3).rand(*gate.shape)
        ).astype(gate.dtype)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
        self.params = convert.import_reference_params(np_params, self.cfg)
        rng = np.random.RandomState(5)
        self.tokens_np = rng.randint(0, self.cfg.vocab_size,
                                     (B, S + STEPS + 1)).astype(np.int32)
        self.jtokens = jnp.asarray(self.tokens_np)
        self.tokens = torch.from_numpy(self.tokens_np.astype(np.int64))
        self.jimg, self.img = _pair(_image(self.cfg), dtype)

    def layer(self, j, r):
        """(reference, port) attention leaves of block r's layer j."""
        jp = jax.tree_util.tree_map(
            lambda a: a[r], self.jparams["stage0"][f"layer{j}"]["attn"])
        return jp, self.params["layers"][2 * r + j]["attn"]


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
def test_plan_interleaves_cross_attention():
    cfg = get_config(ARCH)
    assert [s.kind for s in model.layer_specs(cfg)] == \
        ["attn", "cross_attn"] * 2
    full = get_config("llama-3.2-vision-90b")
    assert [(st.repeat, [s.kind for s in st.layers])
            for st in full.plan()] == [(20, ["attn"] * 4 + ["cross_attn"])]
    # the card's cut: two super-blocks at full width
    cut = dataclasses.replace(full, num_layers=10)
    assert cut.param_count() == 10_825_662_464
    assert sum(s.kind == "attn" for s in model.layer_specs(cut)) == 8


def test_init_cross_layers_and_caches():
    cfg = get_config(ARCH)
    p = model.init(torch.Generator().manual_seed(0), cfg)
    for i, spec in enumerate(model.layer_specs(cfg)):
        a = p["layers"][i]["attn"]
        if spec.kind == "cross_attn":
            assert a["gate"].shape == () and a["gate"].item() == 0.0
            assert a["gate"].dtype == torch.bfloat16
            assert a["wk"].shape == (cfg.d_model,
                                     cfg.num_kv_heads * cfg.head_dim)
        else:
            assert "gate" not in a
    with use_device("cpu"):
        caches = model.init_cache(cfg, B, 20)
    assert [len(c) for c in caches] == [2, 0, 2, 0]
    assert tuple(caches[0][0].shape) == (B, 20, cfg.num_kv_heads,
                                         cfg.head_dim)


def test_image_specs_are_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import specs as jspecs
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    for arch in (ARCH, "llama-3.2-vision-90b"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            fn = {"train_4k": "train_batch_specs",
                  "prefill_32k": "prefill_inputs",
                  "decode_32k": "decode_inputs"}[shape]
            got = getattr(specs, fn)(cfg, SHAPES[shape])["image_embeds"]
            want = getattr(jspecs, fn)(jcfg, JSHAPES[shape])["image_embeds"]
            assert got.is_meta
            assert tuple(got.shape) == tuple(want.shape)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)


# ------------------------------------------------------------- the block
@pytest.mark.parametrize("r", [0, 1])
@pytest.mark.parametrize("s", [S, 1], ids=["prefill", "decode"])
def test_cross_attention_block_matches_the_reference(lm, r, s):
    """Prefill rows and one decode row attend, non-causally and without
    rotation, to the image rows; the output is scaled by tanh(gate)."""
    jp, tp = lm.layer(1, r)
    jx, tx = _pair(_x(lm.cfg, 10 + r, s), lm.dtype)
    y, nc = L.attn_block(tp, tx, lm.cfg, CTX, cross_kv=lm.img)
    jy, _ = jax.jit(lambda p, x, i: JL.attn_block(
        p, x, lm.jcfg, JCTX, cross_kv=i))(jp, jx, lm.jimg)
    assert nc is None and y.dtype == tx.dtype
    _close(y, jy, TOL[lm.dtype])


def test_a_closed_gate_is_the_identity(lm32):
    _, tp = lm32.layer(1, 0)
    x = torch.from_numpy(_x(lm32.cfg, 12))
    y, _ = L.attn_block(dict(tp, gate=torch.zeros(())), x, lm32.cfg, CTX,
                        cross_kv=lm32.img)
    assert torch.equal(y, x)
    y, _ = L.attn_block(tp, x, lm32.cfg, CTX, cross_kv=lm32.img)
    assert (y - x).abs().max() > 1e-3


# ------------------------------------------------------------- the model
def test_forward_and_lm_loss_match_the_reference(lm):
    cfg, jcfg = lm.cfg, lm.jcfg
    hid, aux = model.forward(lm.params, lm.tokens[:, :S], cfg, CTX,
                             image_embeds=lm.img)
    jhid, _ = jax.jit(lambda p, t, i: jmodel.forward(
        p, t, jcfg, JCTX, image_embeds=i))(lm.jparams, lm.jtokens[:, :S],
                                           lm.jimg)
    _close(hid, jhid, TOL32_LOGITS if lm.dtype == "float32" else
           TOL["bfloat16"])
    assert aux.item() == 0.0
    batch = {"tokens": lm.tokens[:, :S + 1], "image_embeds": lm.img}
    loss, metrics = model.lm_loss(lm.params, batch, cfg, CTX)
    jloss, jmetrics = jax.jit(lambda p, t, i: jmodel.lm_loss(
        p, {"tokens": t, "image_embeds": i}, jcfg, JCTX))(
            lm.jparams, lm.jtokens[:, :S + 1], lm.jimg)
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "loss"}
    tol = TOL[lm.dtype]
    for key in ("ce", "loss"):
        want = float(jmetrics[key])
        assert abs(metrics[key].item() - want) <= tol * abs(want), key
    assert abs(loss.item() - float(jloss)) <= tol * abs(float(jloss))


def test_the_image_reaches_the_logits(lm32):
    """Other image embeddings give other logits (the gates are open)."""
    other = torch.from_numpy(_image(lm32.cfg, seed=8))
    _, a = model.prefill(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX,
                         cache_len=S, image_embeds=lm32.img)
    _, b = model.prefill(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX,
                         cache_len=S, image_embeds=other)
    assert (a - b).abs().max() > 1e-3


def test_cross_attention_without_image_embeds_raises(lm32):
    """No silent self-attention in a cross layer: the entry points
    refuse a VLM call without image embeddings."""
    with pytest.raises(ValueError, match="image_embeds"):
        model.forward(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX)
    with pytest.raises(ValueError, match="image_embeds"), use_device("cpu"):
        engine.generate(lm32.params, lm32.tokens[:, :S], lm32.cfg, CTX,
                        max_new_tokens=1)


def test_prefill_caches_and_decode_match_the_reference(lm):
    cfg, jcfg = lm.cfg, lm.jcfg
    cache_len = S + STEPS
    caches, logits = model.prefill(lm.params, lm.tokens[:, :S], cfg, CTX,
                                   cache_len=cache_len, image_embeds=lm.img)
    jcaches, jlogits = jax.jit(lambda p, t, i: jmodel.prefill(
        p, t, jcfg, JCTX, cache_len=cache_len, image_embeds=i))(
            lm.jparams, lm.jtokens[:, :S], lm.jimg)
    _close_rel(logits, jlogits, lm.dtype)
    assert jcaches["stage0"]["layer1"] == ()
    for i, c in enumerate(caches):
        if i % 2:
            assert c == ()
            continue
        jk, jv = jcaches["stage0"]["layer0"]
        _close(c[0], jk[i // 2], TOL[lm.dtype])
        _close(c[1], jv[i // 2], TOL[lm.dtype])
    jdec = jax.jit(lambda p, c, t, pos, i: jmodel.decode_step(
        p, c, t, pos, jcfg, JCTX, image_embeds=i))
    for t in range(S, S + STEPS):
        caches, dec = model.decode_step(lm.params, caches,
                                        lm.tokens[:, t:t + 1], t, cfg, CTX,
                                        image_embeds=lm.img)
        jcaches, jlog = jdec(lm.jparams, jcaches, lm.jtokens[:, t:t + 1],
                             jnp.int32(t), lm.jimg)
        _close_rel(dec, jlog, lm.dtype)
        assert [len(c) for c in caches] == [2, 0, 2, 0]


def test_generate_matches_the_reference(lm):
    with use_device("cpu"):
        got = engine.generate(lm.params, lm.tokens[:, :S], lm.cfg, CTX,
                              max_new_tokens=NEW, image_embeds=lm.img)
    want = jengine.generate(lm.jparams, lm.jtokens[:, :S], lm.jcfg, JCTX,
                            max_new_tokens=NEW, image_embeds=lm.jimg)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_matches_forward():
    """tests/test_models.py's serve-path check at the VLM config (bf16,
    the port's own random init, the gates opened to 1)."""
    cfg = get_config(ARCH)
    params = model.init(torch.Generator().manual_seed(1), cfg)
    for layer, spec in zip(params["layers"], model.layer_specs(cfg)):
        if spec.kind == "cross_attn":
            layer["attn"]["gate"].fill_(1.0)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S + 1)))
    img = torch.from_numpy(_image(cfg, seed=1)).to(torch.bfloat16)
    hid, _ = model.forward(params, tokens, cfg, CTX, image_embeds=img)
    ref = (hid[:, -1] @ params["unembed"]).float()
    caches, _ = model.prefill(params, tokens[:, :S], cfg, CTX,
                              cache_len=S + 4, image_embeds=img)
    _, dec = model.decode_step(params, caches, tokens[:, S:S + 1], S, cfg,
                               CTX, image_embeds=img)
    rel = (dec - ref).abs().max() / (ref.abs().max() + 1e-6)
    assert rel < 0.02


# ---------------------------------------------- gradients and conversion
def test_lm_loss_gradient_matches_jax_grad(lm32):
    """Every float32 gradient leaf of ``lm_loss``, the cross layers'
    ``gate`` and K/V projections included, against ``jax.grad`` of the
    reference's, under remat."""
    jctx = dataclasses.replace(JCTX, remat="full")
    ctx = dataclasses.replace(CTX, remat="full")
    toks = lm32.tokens_np[:, :S + 1]
    (loss, _), grads = ts.loss_and_grads(
        lm32.params, {"tokens": torch.from_numpy(toks.astype(np.int64)),
                      "image_embeds": lm32.img}, lm32.cfg, ctx)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, i: jmodel.lm_loss(p, {"tokens": t, "image_embeds": i},
                                       lm32.jcfg, jctx),
        has_aux=True))(lm32.jparams, jnp.asarray(toks), lm32.jimg)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = tree.flatten_with_names(
        convert.export_reference_params(grads, lm32.cfg))
    want = tree.flatten_with_names(jax.tree_util.tree_map(_np, jgrads))
    assert list(got) == list(want)
    assert "stage0/layer1/attn/gate" in want
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        rel = np.abs(got[name] - w).max() / np.abs(w).max()
        assert rel <= GRAD_TOL, (name, rel)


@pytest.mark.parametrize("microbatch", [0, 1])
def test_train_step_runs_with_image_embeds(microbatch):
    """tests/test_models.py's per-arch smoke: one step (whole or in
    microbatches, each with its rows of the image embeddings), finite
    loss, the cross layers' gates (the only cross leaves with a gradient
    while tanh(gate) is 0) and the self-attention layers moved, all
    finite."""
    cfg = get_config(ARCH)
    state = ts.make_train_state(torch.Generator().manual_seed(0), cfg,
                                OptimizerConfig())
    step = ts.make_train_step(cfg, L.ModelContext(q_chunk=32, k_chunk=32),
                              OptimizerConfig(), microbatch=microbatch)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 25)))
    img = torch.from_numpy(_image(cfg, seed=0, b=2)).to(torch.bfloat16)
    state2, metrics = step(state, {"tokens": tokens, "image_embeds": img})
    assert np.isfinite(metrics["loss"].item())
    before = tree.flatten_with_names(state["params"])
    after = tree.flatten_with_names(state2["params"])
    for name in ("layers/[1]/attn/gate", "layers/[3]/attn/gate",
                 "layers/[2]/attn/wq"):
        assert not torch.equal(before[name], after[name]), name
    assert all(torch.isfinite(t.float()).all() for t in after.values())


def test_convert_round_trip_is_bit_for_bit(lm):
    jflat = tree.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, lm.jparams))
    for layer, spec in zip(lm.params["layers"],
                           model.layer_specs(lm.cfg)):
        if spec.kind == "cross_attn":
            assert layer["attn"]["gate"].shape == ()
    back = tree.flatten_with_names(
        convert.export_reference_params(lm.params, lm.cfg))
    assert back.keys() == jflat.keys()
    for name, want in jflat.items():
        assert back[name].shape == want.shape, name
        np.testing.assert_array_equal(back[name],
                                      want.astype(np.float32), name)
