"""The port's local/global family (``gemma3-4b``) against the reference on
the CPU: ``init``, ``forward``, ``lm_loss``, ``prefill`` (logits and
caches), ``decode_step``, greedy ``generate`` and the parameter
conversion, at ``gemma3-4b-smoke`` (2 super-blocks of one sliding-window
layer, window 8, and one global layer; d 64, 4 heads of 16 over 2 KV
heads) and at a two-stage cut of it (``local_global_ratio`` 5, 8 layers:
one block of 5 window layers and a global one, then 2 window layers), the
full config's plan in small.

Inputs come from numpy seeds; the reference's parameters reach the port
through ``import_reference_params``. Tolerances: float32 rtol=atol=1e-5,
bfloat16 rtol=atol=0.05 (tests/test_torch_ssm.py's bounds) for hidden
states, losses and caches; generated ids equal. bfloat16 logits are held
to the same 0.05 in the relative form tests/test_models.py uses for
logits, max abs difference over the largest |logit|: the attention
blocks agree bit for bit, but the two packages' bf16 FFN products part
by one bf16 step a layer, and the unembedding turns that into logit
differences of ~0.07 at |logit| ~3-4 (0.022 of the largest after four
decode steps), past an elementwise 0.05 where a logit is near 0.
The reference's prompt caches are compared at prompt lengths that are
multiples of the window (8, 16), where its cut of the last ``window``
rows is the ring ``decode_step`` writes. At 4 and 10 the port's decode
equals its own teacher-forced forward within 1e-5 and the reference's
does not (ROADMAP §3).
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

SMOKE = "gemma3-4b-smoke"
TWO_STAGE = "two-stage"          # SMOKE at ratio 5 and 8 layers
CHUNK = 8                        # the window: two attention blocks at S 16
JCTX = JL.ModelContext(remat="none", q_chunk=CHUNK, k_chunk=CHUNK)
CTX = L.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK)
B, NEW, CACHE_LEN, STEPS = 2, 6, 32, 4
TOL = {"float32": 1e-5, "bfloat16": 0.05}
LOGITS_BF16_REL = 0.05


def _configs(cut, dtype):
    """(the reference's config, the port's) of a cut, in ``dtype``."""
    over = dict(dtype=dtype)
    if cut == TWO_STAGE:
        over.update(num_layers=8, local_global_ratio=5)
    return (dataclasses.replace(jget_config(SMOKE), **over),
            dataclasses.replace(get_config(SMOKE), **over))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_logits(got, want, dtype):
    if dtype == "float32":
        _close(got, want, TOL[dtype])
        return
    got, want = _np(got), _np(want)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < LOGITS_BF16_REL, rel


class Model:
    def __init__(self, cut, dtype):
        self.jcfg, self.cfg = _configs(cut, dtype)
        self.jparams = jax.jit(jmodel.init, static_argnums=1)(
            jax.random.PRNGKey(1), self.jcfg)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.params = convert.import_reference_params(self.np_params,
                                                      self.cfg)
        rng = np.random.RandomState(5)
        self.tokens_np = rng.randint(0, self.cfg.vocab_size,
                                     (B, 16 + STEPS)).astype(np.int32)
        self.jtokens = jnp.asarray(self.tokens_np)
        self.tokens = torch.from_numpy(self.tokens_np.astype(np.int64))


@pytest.fixture(scope="module",
                params=[(SMOKE, "float32"), (SMOKE, "bfloat16"),
                        (TWO_STAGE, "float32")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def lm(request):
    return Model(*request.param)


def test_plans_are_the_families(lm):
    specs = model.layer_specs(lm.cfg)
    windows = [spec.window for spec in specs]
    if lm.cfg.num_layers == 8:
        assert [(st.repeat, len(st.layers)) for st in lm.cfg.plan()] == \
            [(1, 6), (2, 1)]
        assert windows == [8] * 5 + [0] + [8] * 2
    else:
        assert windows == [8, 0, 8, 0]
    full = model.layer_specs(get_config("gemma3-4b"))
    assert [(st.repeat, len(st.layers))
            for st in get_config("gemma3-4b").plan()] == [(5, 6), (4, 1)]
    assert sum(s.window == 1024 for s in full) == 29
    assert sum(s.window == 0 for s in full) == 5


def test_forward_and_lm_loss_match_the_reference(lm):
    cfg, jcfg, tol = lm.cfg, lm.jcfg, TOL[lm.cfg.dtype]
    S = 16
    hid, aux = model.forward(lm.params, lm.tokens[:, :S], cfg, CTX)
    jhid, jaux = jax.jit(lambda p, t: jmodel.forward(p, t, jcfg, JCTX))(
        lm.jparams, lm.jtokens[:, :S])
    assert hid.dtype == getattr(torch, cfg.dtype)
    _close(hid, jhid, tol)
    assert float(aux) == float(jaux) == 0.0
    loss, metrics = model.lm_loss(lm.params,
                                  {"tokens": lm.tokens[:, :S + 1]}, cfg, CTX)
    jloss, jmetrics = jax.jit(lambda p, t: jmodel.lm_loss(
        p, {"tokens": t}, jcfg, JCTX))(lm.jparams, lm.jtokens[:, :S + 1])
    for key in ("ce", "aux", "loss"):
        _close(metrics[key], jmetrics[key], tol)
    _close(loss, jloss, tol)


def _ref_caches(jcaches, cfg):
    """The reference's stacked caches in the port's order."""
    return [tuple(a[r] for a in jcaches[f"stage{si}"][f"layer{j}"])
            for si, st in enumerate(cfg.plan()) for r in range(st.repeat)
            for j in range(len(st.layers))]


@pytest.mark.parametrize("S", [8, 16])
def test_prefill_and_decode_match_the_reference(lm, S):
    """Prompt lengths that are multiples of the window: the caches have
    the reference's rows (8 for a window layer, ``CACHE_LEN`` for a
    global one) and values; then ``STEPS`` decode steps, each step's
    logits and caches."""
    cfg, jcfg, tol = lm.cfg, lm.jcfg, TOL[lm.cfg.dtype]
    caches, logits = model.prefill(lm.params, lm.tokens[:, :S], cfg, CTX,
                                   cache_len=CACHE_LEN)
    jcaches, jlogits = jax.jit(lambda p, t: jmodel.prefill(
        p, t, jcfg, JCTX, cache_len=CACHE_LEN))(lm.jparams,
                                                lm.jtokens[:, :S])
    assert logits.shape == (B, cfg.padded_vocab_size)
    _close_logits(logits, jlogits, cfg.dtype)
    specs = model.layer_specs(cfg)
    want = _ref_caches(jcaches, cfg)
    assert len(caches) == len(want) == len(specs)
    for spec, got, ref in zip(specs, caches, want):
        rows = 8 if spec.window else CACHE_LEN
        for a, b in zip(got, ref):
            assert tuple(a.shape) == b.shape == (B, rows, cfg.num_kv_heads,
                                                 cfg.head_dim)
            assert a.dtype == getattr(torch, cfg.dtype)
            _close(a, b, tol)
    jdecode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, c, t, pos, jcfg, JCTX))
    for pos in range(S, S + STEPS):
        caches, dec = model.decode_step(lm.params, caches,
                                        lm.tokens[:, pos:pos + 1], pos, cfg,
                                        CTX)
        jcaches, jdec = jdecode(lm.jparams, jcaches,
                                lm.jtokens[:, pos:pos + 1], jnp.int32(pos))
        _close_logits(dec, jdec, cfg.dtype)
        for got, ref in zip(caches, _ref_caches(jcaches, cfg)):
            for a, b in zip(got, ref):
                _close(a, b, tol)


def test_generate_matches_the_reference(lm):
    S = 16
    with use_device("cpu"):
        got = engine.generate(lm.params, lm.tokens[:, :S], lm.cfg, CTX,
                              max_new_tokens=NEW)
    want = jengine.generate(lm.jparams, lm.jtokens[:, :S], lm.jcfg, JCTX,
                            max_new_tokens=NEW)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_round_trip_is_bit_for_bit(lm):
    jflat = tree.flatten_with_names(lm.np_params)
    back = tree.flatten_with_names(
        convert.export_reference_params(lm.params, lm.cfg))
    assert back.keys() == jflat.keys()
    for name, want in jflat.items():
        np.testing.assert_array_equal(back[name], want.astype(np.float32),
                                      name)
    assert sum(t.numel() for t in tree.leaves(lm.params)) == \
        sum(a.size for a in jflat.values())
    if lm.cfg.num_layers == 8:
        assert jflat["stage0/layer5/attn/wq"].shape[0] == 1
        assert jflat["stage1/layer0/ffn/w1"].shape[0] == 2


# --------------------------------------- prompts off the window's multiple
@pytest.mark.parametrize("cut", [SMOKE, TWO_STAGE])
@pytest.mark.parametrize("S", [4, 10])
def test_decode_equals_the_ports_own_forward_off_the_windows_multiple(
        S, cut):
    """float32: prefill of S tokens, then ``STEPS + 6`` teacher-forced
    decode steps (past the window's wrap), each step's logits against the
    forward over the same tokens at that position, within 1e-5. The
    reference's first decode step, at S=4 (a cache shorter than its ring)
    and S=10 (a ring out of phase), is off by far more."""
    jcfg, cfg = _configs(cut, "float32")
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                     jcfg)
    params = convert.import_reference_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    steps = STEPS + 6
    tokens_np = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    tokens = torch.from_numpy(tokens_np.astype(np.int64))
    hid, _ = model.forward(params, tokens, cfg, CTX)
    want = (hid @ params["unembed"]).float()             # [B, S+steps, Vp]
    caches, logits = model.prefill(params, tokens[:, :S], cfg, CTX,
                                   cache_len=CACHE_LEN)
    _close(logits, want[:, S - 1], 1e-5)
    for pos in range(S, S + steps):
        caches, logits = model.decode_step(params, caches,
                                           tokens[:, pos:pos + 1], pos, cfg,
                                           CTX)
        _close(logits, want[:, pos], 1e-5)
    jtokens = jnp.asarray(tokens_np)
    jcaches, _ = jmodel.prefill(jparams, jtokens[:, :S], jcfg, JCTX,
                                cache_len=CACHE_LEN)
    _, jdec = jmodel.decode_step(jparams, jcaches, jtokens[:, S:S + 1],
                                 jnp.int32(S), jcfg, JCTX)
    assert np.abs(_np(jdec) - _np(want[:, S])).max() > 1e-2


@pytest.mark.parametrize("S, cache_len", [(4, 32), (8, 32), (10, 32),
                                          (16, 32), (21, 32), (10, 6),
                                          (5, 5)])
def test_a_window_layers_prompt_cache_is_the_ring(S, cache_len):
    """Position t of the prompt sits in row ``t % rows`` of a window
    layer's cache, ``rows = min(window, cache_len)``, for the prompt's
    last ``rows`` positions; rows no position reached are zero. A global
    layer keeps the prompt in order, zero after it."""
    cfg = get_config(SMOKE)
    local, glob = model.layer_specs(cfg)[:2]
    raw = torch.arange(1, S + 1, dtype=torch.float32).reshape(1, S, 1, 1)
    f32 = dataclasses.replace(cfg, dtype="float32")
    k, v = model._fold_prefill_cache(local, (raw, raw + 100), f32,
                                     cache_len)
    rows = min(8, cache_len)
    want = torch.zeros(rows)
    for t in range(max(0, S - rows), S):
        want[t % rows] = t + 1
    assert torch.equal(k.flatten(), want)
    assert torch.equal(v.flatten(), torch.where(want > 0, want + 100, 0.))
    if S <= cache_len:
        k, _ = model._fold_prefill_cache(glob, (raw, raw), f32, cache_len)
        assert torch.equal(k.flatten()[:S], raw.flatten())
        assert not k.flatten()[S:].any()


def test_init_leaves_equal_the_references_shapes_and_dtypes():
    """Full width and depth on ``meta`` tensors, in the reference's
    stacked layout: ``stage0/layer0..5`` 5 deep, ``stage1/layer0`` 4 deep,
    every leaf's shape and dtype, and no other leaf; the caches of a
    ``decode_32k`` cell have 1024 rows in a window layer."""
    from functools import partial
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import specs as jspecs
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    jcfg, cfg = jget_config("gemma3-4b"), get_config("gemma3-4b")
    jshapes = jax.eval_shape(partial(jmodel.init, cfg=jcfg),
                             jax.random.PRNGKey(0))
    want = {"/".join(k.key for k in path): (tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_leaves_with_path(jshapes)}
    meta = model.init(L.ShapesOnly(), cfg)
    assert all(t.is_meta for t in tree.leaves(meta))
    got = {}
    own = iter(meta["layers"])
    for si, stage in enumerate(cfg.plan()):
        reps = [[next(own) for _ in stage.layers]
                for _ in range(stage.repeat)]
        for j in range(len(stage.layers)):
            for name, t in tree.flatten_with_names(reps[0][j]).items():
                got[f"stage{si}/layer{j}/{name}"] = (
                    (stage.repeat,) + tuple(t.shape),
                    str(t.dtype).split(".")[-1])
    for k in ("embed", "unembed", "final_ln"):
        got[k] = (tuple(meta[k].shape), str(meta[k].dtype).split(".")[-1])
    assert got == want
    assert cfg.param_count() == 4_550_993_920           # 9.10 GB in bf16
    # param_count counts every layer's norms but not the final one
    assert sum(t.numel() for t in tree.leaves(meta)) == \
        cfg.param_count() + cfg.d_model
    jin = jspecs.decode_inputs(jcfg, JSHAPES["decode_32k"])["caches"]
    pin = specs.decode_inputs(cfg, SHAPES["decode_32k"])["caches"]
    ref = [tuple(a.shape[1:] for a in jin[f"stage{si}"][f"layer{j}"])
           for si, st in enumerate(cfg.plan()) for _ in range(st.repeat)
           for j in range(len(st.layers))]
    assert [tuple(tuple(t.shape) for t in pair) for pair in pin] == ref
    assert sorted({pair[0].shape[1] for pair in pin}) == [1024, 32768]
