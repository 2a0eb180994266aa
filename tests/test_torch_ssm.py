"""The port's SSM, hybrid and audio families against the reference on the
CPU: ``models/ssm.py`` function by function, and ``forward``,
``lm_loss``, ``prefill``, ``decode_step`` and greedy ``generate`` at
``mamba2-370m-smoke`` (4 Mamba2 layers; d 64, 8 SSM heads of 16, state
16), ``zamba2-2.7b-smoke`` (2 super-blocks of 2 Mamba2 layers and the
shared attention, 4 heads of 16 over 2 KV heads) and
``musicgen-medium-smoke`` (4 dense layers, 4 heads over 2 KV heads).

Inputs come from numpy seeds; the reference's parameters
(``repro.models.model.init``) reach the port through
``import_reference_params``. Tolerances: float32 (the config with
``dtype="float32"``) rtol=atol=1e-5; bfloat16 rtol=atol=0.05 (the
reference's own bound for its MoE block in bf16, tests/test_models.py);
generated ids equal. The port's own prefill + decode against its
forward: 0.08 relative (SSM, hybrid) and 0.02 (audio), and stepwise
decode against the chunked scan 0.08, tests/test_models.py's bounds.
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
from repro.models import ssm as JSSM
from repro.serve import engine as jengine
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train.train_step import make_train_state as jmake_train_state
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import use_device
from repro_torch.models import convert, layers as L, model, ssm
from repro_torch.serve import engine

ARCHS = ("mamba2-370m-smoke", "zamba2-2.7b-smoke", "musicgen-medium-smoke")
CHUNK = 8                        # two SSD chunks and two attention blocks
JCTX = JL.ModelContext(remat="none", q_chunk=CHUNK, k_chunk=CHUNK,
                       ssd_chunk=CHUNK)
CTX = L.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK, ssd_chunk=CHUNK)
B, S, NEW = 2, 16, 6
TOL = {"float32": 1e-5, "bfloat16": 0.05}
SERVE_REL = {"mamba2-370m-smoke": 0.08, "zamba2-2.7b-smoke": 0.08,
             "musicgen-medium-smoke": 0.02}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, convert.to_tensor(np.asarray(j))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)
            ).astype(np.float32)


# ---------------------------------------- ssm.py, function by function
def test_segsum_matches_the_reference():
    a = -np.abs(_rand(0, 2, 3, 8))
    got = ssm._segsum(torch.from_numpy(a))
    want = JSSM._segsum(jnp.asarray(a))
    assert torch.isinf(got).sum() == 2 * 3 * 28       # above the diagonal
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_the_reference(dtype):
    jx, tx = _pair(_rand(1, B, S, 24), dtype)
    jw, tw = _pair(_rand(2, 4, 24, scale=0.3), dtype)
    jb, tb = _pair(_rand(3, 24, scale=0.1), dtype)
    got = ssm._causal_conv(tx, tw, tb)
    assert got.dtype == tx.dtype
    _close(got, JSSM._causal_conv(jx, jw, jb), TOL[dtype])


def _scan_inputs(seed, b, s, h, p, g, n, dtype="float32"):
    x = _rand(seed, b, s, h, p)
    dt = np.log1p(np.exp(_rand(seed + 1, b, s, h) - 2.0)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    Bm = _rand(seed + 2, b, s, g, n, scale=0.5)
    Cm = _rand(seed + 3, b, s, g, n, scale=0.5)
    return [_pair(x, dtype)] + [_pair(a, "float32") for a in (dt, A)] + \
        [_pair(a, dtype) for a in (Bm, Cm)]


@pytest.mark.parametrize("s, chunk, g, with_state", [
    (16, 8, 1, False),           # two chunks
    (12, 8, 1, False),           # s % chunk != 0: one chunk of 12
    (16, 4, 2, False),           # two groups: repeat_interleave, not repeat
    (16, 8, 2, True),            # a carried-in state
])
def test_ssd_scan_matches_the_reference(s, chunk, g, with_state):
    b, h, p, n = 2, 4, 8, 16
    pairs = _scan_inputs(10 + s + g, b, s, h, p, g, n)
    jargs, targs = [j for j, _ in pairs], [t for _, t in pairs]
    jinit = tinit = None
    if with_state:
        jinit, tinit = _pair(_rand(7, b, h, p, n, scale=0.3), "float32")
    y, state = ssm.ssd_scan(*targs, chunk, init_state=tinit)
    jy, jstate = JSSM.ssd_scan(*jargs, chunk, init_state=jinit)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    assert y.dtype == state.dtype == torch.float32
    _close(y, jy, 1e-5)
    _close(state, jstate, 1e-5)


def test_ssd_scan_broadcasts_groups_to_consecutive_heads():
    """With two groups, heads 0-1 read group 0 and heads 2-3 group 1
    (``jnp.repeat``); ``Tensor.repeat`` would give heads 0 and 2 group 0.
    A zero C in group 1 silences the output of heads 2-3 only."""
    pairs = _scan_inputs(3, 1, 8, 4, 4, 2, 8)
    x, dt, A, Bm, Cm = [t for _, t in pairs]
    Cm = Cm.clone()
    Cm[:, :, 1] = 0
    y, _ = ssm.ssd_scan(x, dt, A, Bm, Cm, 8)
    assert torch.equal(y[:, :, 2:], torch.zeros_like(y[:, :, 2:]))
    assert y[:, :, :2].abs().max() > 0


def _mamba_cfgs(dtype, ngroups=1):
    arch = "mamba2-370m-smoke"
    return (dataclasses.replace(jget_config(arch), dtype=dtype,
                                ssm_ngroups=ngroups),
            dataclasses.replace(get_config(arch), dtype=dtype,
                                ssm_ngroups=ngroups))


def _mamba_params(jcfg, seed=4):
    jp = JSSM.init_mamba(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: convert.to_tensor(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_chunked_path_matches_the_reference(dtype, ngroups):
    jcfg, cfg = _mamba_cfgs(dtype, ngroups)
    jp, tp = _mamba_params(jcfg)
    jx, tx = _pair(_rand(5, B, S, cfg.d_model, scale=0.5), dtype)
    y, (tail, state) = ssm.mamba_block(tp, tx, cfg, CTX, return_state=True)
    jy, (jtail, jstate) = JSSM.mamba_block(jp, jx, jcfg, JCTX,
                                           return_state=True)
    assert y.dtype == tx.dtype and state.dtype == torch.float32
    assert tail.shape == (B, cfg.ssm_conv - 1, ssm._conv_channels(cfg))
    _close(y, jy, TOL[dtype])
    _close(tail, jtail, TOL[dtype])
    _close(state, jstate, TOL[dtype])
    y2, none = ssm.mamba_block(tp, tx, cfg, CTX)
    assert none is None and torch.equal(y2, y)


@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_decode_path_matches_the_reference(dtype, ngroups):
    jcfg, cfg = _mamba_cfgs(dtype, ngroups)
    jp, tp = _mamba_params(jcfg)
    C = ssm._conv_channels(cfg)
    jx, tx = _pair(_rand(6, B, 1, cfg.d_model, scale=0.5), dtype)
    jconv, tconv = _pair(_rand(7, B, cfg.ssm_conv - 1, C, scale=0.5), dtype)
    jst, tst = _pair(_rand(8, B, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state, scale=0.3), "float32")
    y, (conv, state) = ssm.mamba_block(tp, tx, cfg, CTX, cache=(tconv, tst))
    jy, (jconv2, jst2) = JSSM.mamba_block(jp, jx, jcfg, JCTX,
                                          cache=(jconv, jst))
    assert y.shape == (B, 1, cfg.d_model) and y.dtype == tx.dtype
    assert conv.dtype == tconv.dtype and state.dtype == torch.float32
    _close(y, jy, TOL[dtype])
    _close(conv, jconv2, TOL[dtype])
    _close(state, jst2, TOL[dtype])


def test_init_mamba_cache_shapes_and_dtypes():
    _, cfg = _mamba_cfgs("bfloat16")
    conv, state = ssm.init_mamba_cache(cfg, 3, torch.bfloat16)
    jconv, jstate = JSSM.init_mamba_cache(cfg, 3, jnp.bfloat16)
    assert conv.shape == jconv.shape and state.shape == jstate.shape
    assert conv.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert not conv.any() and not state.any()


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0])
    want = jax.nn.softplus(jnp.asarray(x.numpy()))
    _close(ssm._softplus(x), want, 1e-6)


# ------------------------------------------------------------- the models
class Model:
    def __init__(self, arch, dtype):
        self.arch = arch
        self.jcfg = dataclasses.replace(jget_config(arch), dtype=dtype)
        self.cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        self.jparams = jax.jit(jmodel.init, static_argnums=1)(
            jax.random.PRNGKey(1), self.jcfg)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.params = convert.import_reference_params(self.np_params,
                                                      self.cfg)
        rng = np.random.RandomState(5)
        self.tokens_np = rng.randint(0, self.cfg.vocab_size,
                                     (B, S + 1)).astype(np.int32)
        self.jtokens = jnp.asarray(self.tokens_np)
        self.tokens = torch.from_numpy(self.tokens_np.astype(np.int64))


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def lm(request):
    return Model(*request.param)


def test_forward_and_lm_loss_match_the_reference(lm):
    cfg, jcfg, tol = lm.cfg, lm.jcfg, TOL[lm.cfg.dtype]
    hid, aux = model.forward(lm.params, lm.tokens[:, :S], cfg, CTX)
    jhid, jaux = jax.jit(lambda p, t: jmodel.forward(p, t, jcfg, JCTX))(
        lm.jparams, lm.jtokens[:, :S])
    assert hid.dtype == getattr(torch, cfg.dtype)
    _close(hid, jhid, tol)
    assert float(aux) == float(jaux) == 0.0
    # remat recomputes each layer in the backward; the forward is the same
    rhid, _ = model.forward(lm.params, lm.tokens[:, :S], cfg,
                            dataclasses.replace(CTX, remat="full"))
    assert torch.equal(rhid, hid)
    loss, metrics = model.lm_loss(lm.params, {"tokens": lm.tokens}, cfg,
                                  CTX)
    jloss, jmetrics = jax.jit(lambda p, t: jmodel.lm_loss(
        p, {"tokens": t}, jcfg, JCTX))(lm.jparams, lm.jtokens)
    for key in ("ce", "aux", "loss"):
        _close(metrics[key], jmetrics[key], tol)
    _close(loss, jloss, tol)


def _ref_caches(jcaches, cfg):
    """The reference's stacked caches in the port's order: every repeat
    of every stage, each repeat's layers in order."""
    return [tuple(a[r] for a in jcaches[f"stage{si}"][f"layer{j}"])
            for si, st in enumerate(cfg.plan()) for r in range(st.repeat)
            for j in range(len(st.layers))]


def test_prefill_and_decode_match_the_reference(lm):
    cfg, jcfg, tol = lm.cfg, lm.jcfg, TOL[lm.cfg.dtype]
    cache_len = S + 4
    caches, logits = model.prefill(lm.params, lm.tokens[:, :S], cfg, CTX,
                                   cache_len=cache_len)
    jcaches, jlogits = jax.jit(lambda p, t: jmodel.prefill(
        p, t, jcfg, JCTX, cache_len=cache_len))(lm.jparams,
                                                lm.jtokens[:, :S])
    assert logits.shape == (B, cfg.padded_vocab_size)
    _close(logits, jlogits, tol)
    specs = model.layer_specs(cfg)
    want = _ref_caches(jcaches, cfg)
    assert len(caches) == len(want) == len(specs)
    for spec, got, ref in zip(specs, caches, want):
        for a, b in zip(got, ref):
            assert tuple(a.shape) == b.shape
            assert a.dtype == (torch.float32 if a.ndim == 4 and
                               spec.kind == "mamba" else
                               getattr(torch, cfg.dtype))
            _close(a, b, tol)
    caches, dec = model.decode_step(lm.params, caches,
                                    lm.tokens[:, S:S + 1], S, cfg, CTX)
    jcaches, jdec = jax.jit(lambda p, c, t: jmodel.decode_step(
        p, c, t, jnp.int32(S), jcfg, JCTX))(lm.jparams, jcaches,
                                            lm.jtokens[:, S:S + 1])
    _close(dec, jdec, tol)
    for got, ref in zip(caches, _ref_caches(jcaches, cfg)):
        for a, b in zip(got, ref):
            _close(a, b, tol)


def test_generate_matches_the_reference(lm):
    with use_device("cpu"):
        got = engine.generate(lm.params, lm.tokens[:, :S], lm.cfg, CTX,
                              max_new_tokens=NEW)
    want = jengine.generate(lm.jparams, lm.jtokens[:, :S], lm.jcfg, JCTX,
                            max_new_tokens=NEW)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """tests/test_models.py's serve-path check (bf16, the port's own
    random init)."""
    cfg = get_config(arch)
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
    assert rel < SERVE_REL[arch]


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_decode_stream_matches_scan(arch):
    """tests/test_models.py's stepwise decode over T tokens from empty
    caches against the chunked scan's teacher forcing (bf16, the port's
    own init)."""
    cfg = get_config(arch)
    params = model.init(torch.Generator().manual_seed(2), cfg)
    T = 12
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, T)))
    hid, _ = model.forward(params, tokens, cfg, CTX)
    ref = (hid[:, -1] @ params["unembed"]).float()
    with use_device("cpu"):
        caches = model.init_cache(cfg, 1, T + 2)
    for t in range(T):
        caches, logits = model.decode_step(params, caches,
                                           tokens[:, t:t + 1], t, cfg, CTX)
    rel = (logits - ref).abs().max() / (ref.abs().max() + 1e-6)
    assert rel < 0.08


# ---------------------------------------------------- init and conversion
def test_convert_round_trip_is_bit_for_bit(lm):
    jflat = tree.flatten_with_names(lm.np_params)
    back = tree.flatten_with_names(
        convert.export_reference_params(lm.params, lm.cfg))
    assert back.keys() == jflat.keys()
    for name, want in jflat.items():
        np.testing.assert_array_equal(back[name], want.astype(np.float32),
                                      name)
    # every leaf once: the shared attention is not copied per application
    assert sum(t.numel() for t in tree.leaves(lm.params)) == \
        sum(a.size for a in jflat.values())


def test_shared_attention_is_held_once():
    m = Model("zamba2-2.7b-smoke", "float32")
    cfg, params = m.cfg, m.params
    specs = model.layer_specs(cfg)
    per_app = model.layer_params(params, cfg)
    shared = [p for spec, p in zip(specs, per_app) if spec.shared]
    assert len(shared) == cfg.plan()[0].repeat == 2
    held = params["stage0_shared"]["layer2"]
    assert all(p is held for p in shared)
    assert all(p["attn"]["wq"] is held["attn"]["wq"] for p in shared)
    assert set(held) == {"attn"}                     # ffn="none"
    assert len(params["layers"]) == cfg.num_layers == 4
    assert all(set(p) == {"attn"} and "in_proj" in p["attn"]
               for p in params["layers"])
    # a gradient of the shared leaf sums over its applications
    loss, _ = model.lm_loss(
        tree.tree_map(lambda t: t.requires_grad_(t.is_floating_point()),
                      params), {"tokens": m.tokens}, cfg, CTX)
    loss.backward()
    assert held["attn"]["wq"].grad is not None
    # each application keeps its own KV cache
    caches, _ = model.prefill(params, m.tokens[:, :S], cfg, CTX,
                              cache_len=S)
    attn = [c for spec, c in zip(specs, caches) if spec.kind == "attn"]
    assert len(attn) == 2 and attn[0][0] is not attn[1][0]
    assert not torch.equal(attn[0][0], attn[1][0])


def test_train_state_converts_with_the_shared_leaves():
    jcfg = dataclasses.replace(jget_config("zamba2-2.7b-smoke"),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("zamba2-2.7b-smoke"),
                              dtype="float32")
    state = jax.tree_util.tree_map(np.asarray, jmake_train_state(
        jax.random.PRNGKey(0), jcfg, JOptimizerConfig()))
    got = convert.import_reference_train_state(state, cfg)
    for key, ref in (("params", state["params"]),
                     ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"])):
        ours = got["params"] if key == "params" else got["opt"][key]
        assert "stage0_shared" in ours
        back = tree.flatten_with_names(
            convert.export_reference_params(ours, cfg))
        want = tree.flatten_with_names(ref)
        assert back.keys() == want.keys()
        for name, a in want.items():
            np.testing.assert_array_equal(back[name], a, name)
    assert int(got["step"]) == int(state["step"])


def _reference_layout(meta, cfg):
    """name -> (shape, dtype) of the port's leaves in the reference's
    layout: each stage's non-shared layers stacked along a repeat axis,
    its shared layers once."""
    dt = lambda t: str(t.dtype).split(".")[-1]
    out = {k: (tuple(meta[k].shape), dt(meta[k]))
           for k in ("embed", "unembed", "final_ln")}
    own = iter(meta["layers"])
    for si, stage in enumerate(cfg.plan()):
        per = [j for j, spec in enumerate(stage.layers) if not spec.shared]
        reps = [[next(own) for _ in per] for _ in range(stage.repeat)]
        for i, j in enumerate(per):
            for name, t in tree.flatten_with_names(reps[0][i]).items():
                assert len({(tuple(r[i][part][leaf].shape), dt(
                    r[i][part][leaf])) for r in reps
                    for part, leaf in [name.split("/")]}) == 1
                out[f"stage{si}/layer{j}/{name}"] = (
                    (stage.repeat,) + tuple(t.shape), dt(t))
        for j, spec in enumerate(stage.layers):
            if spec.shared:
                for name, t in tree.flatten_with_names(
                        meta[f"stage{si}_shared"][f"layer{j}"]).items():
                    out[f"stage{si}_shared/layer{j}/{name}"] = (
                        tuple(t.shape), dt(t))
    assert next(own, None) is None
    return out


@pytest.mark.parametrize("arch", [a[:-len("-smoke")] for a in ARCHS])
def test_init_leaves_equal_the_references_shapes_and_dtypes(arch):
    """Full width and depth on ``meta`` tensors: every leaf of the
    reference's ``init`` (``jax.eval_shape``) in the port's layout, with
    its shape and dtype, and no other."""
    from functools import partial
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes = jax.eval_shape(partial(jmodel.init, cfg=jcfg),
                             jax.random.PRNGKey(0))
    want = {"/".join(k.key for k in path): (tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_leaves_with_path(jshapes)}
    meta = model.init(L.ShapesOnly(), cfg)
    assert all(t.is_meta for t in tree.leaves(meta))
    assert _reference_layout(meta, cfg) == want


def test_init_uses_the_reference_scales_and_dtypes():
    cfg = get_config("zamba2-2.7b-smoke")
    p = model.init(torch.Generator().manual_seed(0), cfg)
    d, d_in, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    m = p["layers"][0]["attn"]
    jm = JSSM.init_mamba(jax.random.PRNGKey(0), jget_config(
        "zamba2-2.7b-smoke"))
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in m.items()} == \
        {k: (a.shape, str(a.dtype)) for k, a in jm.items()}
    for name in ("A_log", "D", "dt_bias"):
        assert m[name].dtype == torch.float32
        _close(m[name], jm[name], 1e-6)
    for name in ("conv_b", "gnorm", "ln"):
        assert not m[name].any()
    for name, std in (("in_proj", d ** -0.5), ("out_proj", d_in ** -0.5),
                      ("conv_w", 0.1)):
        assert abs(m[name].float().std().item() / std - 1) < 0.1, name
    a = p["stage0_shared"]["layer2"]["attn"]
    assert a["wq"].shape == (d, cfg.num_heads * cfg.head_dim)
    assert h == 8 and not p["final_ln"].any()
