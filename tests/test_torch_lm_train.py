"""LM training in the port against the reference, on the CPU, at
``qwen2-7b-smoke`` (4 layers, d 64, 4 heads over 2 KV heads, head_dim
16, vocab 256 padded to 512): ``fused_ce``, ``lm_loss`` with every
gradient leaf (``jax.grad``), one ``make_train_step`` step (plain,
microbatched, int8-compressed) against the reference's jitted step,
remat, the int8 quantizer, the state's shapes and the launcher.

Inputs come from numpy seeds; the reference's parameters and training
state reach the port through ``models.convert``. Tolerances, each of a
leaf's largest |value| (the reference's):

* float32: 1e-5 (tests/test_torch_models.py's layer tolerance);
* bfloat16 gradients: 5e-2. Measured on these inputs, the reference's
  own bf16 gradient is up to 3.4% from the float32 gradient of the same
  weights and the port's up to 4.6% (``attn/bk``, whose terms nearly
  cancel), so two bf16 gradients cannot agree to 2e-2; the test also
  asks that the port be no further from the float32 gradient than twice
  the reference's worst leaf;
* after an AdamW step a few elements flip (the sign of the first step
  on a near-zero gradient, an int8 or a bf16 rounding step): at most
  0.1% of a tree's elements may fall outside the tolerance. Measured:
  0.02-0.03%.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import compression as jcomp
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import tree
from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import get_config
from repro_torch.distributed import compression as comp
from repro_torch.launch import train as launch
from repro_torch.models import convert, layers as L, model
from repro_torch.train import OptimizerConfig
from repro_torch.train import train_step as ts

ARCH = "qwen2-7b-smoke"
DENSE = ["qwen2-7b", "granite-3-8b", "deepseek-coder-33b"]
TOL32, TOL_BF16 = 1e-5, 5e-2
FLIP_BUDGET = 1e-3
B, S = 4, 32
JCTX = JL.ModelContext(remat="full", q_chunk=16, k_chunk=16)
CTX = L.ModelContext(remat="full", q_chunk=16, k_chunk=16)
LR = 1e-3


def _cfgs(dtype, arch=ARCH):
    return (dataclasses.replace(jget_config(arch), dtype=dtype),
            dataclasses.replace(get_config(arch), dtype=dtype))


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


def _ref_layout(port_tree) -> dict:
    """name -> float32 numpy leaf, in the reference's names and layout."""
    return tree.flatten_with_names(convert.export_reference_params(port_tree))


def _jflat(jtree) -> dict:
    return tree.flatten_with_names(jax.tree_util.tree_map(_np, jtree))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_grads(params, tokens, cfg, ctx):
    (loss, metrics), grads = ts.loss_and_grads(
        params, {"tokens": torch.from_numpy(tokens)}, cfg, ctx)
    return loss, metrics, grads


def _ref_grads(jparams, tokens, jcfg):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.lm_loss(p, b, jcfg, JCTX), has_aux=True))(
            jparams, {"tokens": jnp.asarray(tokens)})
    return loss, metrics, grads


# ----------------------------------------------------------------- fused_ce
CE_CASES = {"divisible": (8, 4), "short": (4, 8), "ragged": (6, 4)}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_fused_ce_matches_reference(case):
    s, chunk = CE_CASES[case]
    vocab, vp, d = 33, 40, 16                 # 7 padded columns
    rng = np.random.RandomState(len(case))
    x = rng.randn(2, s, d).astype(np.float32)
    u = (rng.randn(d, vp) / 4).astype(np.float32)
    t = rng.randint(0, vocab, (2, s)).astype(np.int32)
    jl, (jgx, jgu) = jax.value_and_grad(
        lambda x, u: jmodel.fused_ce(x, u, jnp.asarray(t), vocab, chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
    tx = torch.from_numpy(x).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    loss = model.fused_ce(tx, tu, torch.from_numpy(t), vocab, chunk=chunk)
    gx, gu = torch.autograd.grad(loss, [tx, tu])
    assert abs(loss.item() - float(jl)) <= TOL32 * abs(float(jl))
    assert _rel(gx.numpy(), _np(jgx)) <= TOL32
    assert _rel(gu.numpy(), _np(jgu)) <= TOL32
    # the padded vocab is masked: no gradient, and its logits change nothing
    assert not gu[:, vocab:].any()
    u2 = u.copy()
    u2[:, vocab:] = 50.0
    again = model.fused_ce(torch.from_numpy(x), torch.from_numpy(u2),
                           torch.from_numpy(t), vocab, chunk=chunk)
    assert again.item() == loss.item()


# ------------------------------------------------------------------ lm_loss
@functools.lru_cache(maxsize=None)
def _grads_pair(dtype):
    jcfg, cfg = _cfgs(dtype)
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                     jcfg)
    params = convert.import_reference_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    tokens = _tokens(cfg, seed=5)
    jl, jm, jg = _ref_grads(jparams, tokens, jcfg)
    loss, metrics, grads = _port_grads(params, tokens, cfg, CTX)
    return dict(dtype=dtype, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params, tokens=tokens, jl=jl, jm=jm, jg=jg,
                loss=loss, metrics=metrics, grads=grads)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def grads_pair(request):
    return _grads_pair(request.param)


def test_lm_loss_and_every_gradient_leaf_match_reference(grads_pair):
    g = grads_pair
    tol = TOL32 if g["dtype"] == "float32" else TOL_BF16
    assert set(g["metrics"]) == {"ce", "aux", "loss"}
    for k in ("ce", "loss"):
        want = float(g["jm"][k])
        assert abs(g["metrics"][k].item() - want) <= tol * abs(want), k
    assert g["metrics"]["aux"].item() == float(g["jm"]["aux"]) == 0.0
    got, want = _ref_layout(g["grads"]), _jflat(g["jg"])
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= tol, (name, _rel(got[name], w))


def test_bf16_gradients_are_as_close_to_float32_as_the_reference():
    g = _grads_pair("bfloat16")
    jcfg32 = dataclasses.replace(g["jcfg"], dtype="float32")
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                  g["jparams"])
    _, _, exact = _ref_grads(jp32, g["tokens"], jcfg32)
    exact, ref, port = _jflat(exact), _jflat(g["jg"]), _ref_layout(g["grads"])
    ref_worst = max(_rel(ref[n], w) for n, w in exact.items())
    port_worst = max(_rel(port[n], w) for n, w in exact.items())
    assert port_worst <= 2 * ref_worst, (port_worst, ref_worst)


def test_remat_full_equals_none_bit_for_bit(grads_pair):
    g = grads_pair
    loss, _, grads = _port_grads(g["params"], g["tokens"], g["cfg"],
                                 dataclasses.replace(CTX, remat="none"))
    assert torch.equal(loss, g["loss"])
    for a, b in zip(tree.leaves(grads), tree.leaves(g["grads"])):
        assert torch.equal(a, b)


def test_remat_takes_only_none_or_full():
    assert L.ModelContext().remat == "none"
    with pytest.raises(ValueError):
        L.ModelContext(remat="selective")


def test_lm_loss_refuses_what_the_port_does_not_run():
    cfg = dataclasses.replace(get_config(ARCH), mtp_depth=1)
    with pytest.raises(NotImplementedError, match=cfg.name):
        model.lm_loss({}, {"tokens": torch.zeros(1, 3, dtype=torch.long)},
                      cfg, CTX)


# --------------------------------------------------------------- train step
def _trees(state):
    return {"params": state["params"], "mu": state["opt"]["mu"],
            "nu": state["opt"]["nu"], **({"err": state["err"]}
                                          if "err" in state else {})}


def _outside(got: dict, want: dict, limit) -> tuple:
    """(elements outside limit(name, want) , elements)."""
    out = total = 0
    for name, w in want.items():
        out += int((np.abs(got[name] - w) > limit(name, w)).sum())
        total += w.size
    return out, total


STEP_CASES = {
    "plain-float32": ("float32", dict()),
    "microbatch-float32": ("float32", dict(microbatch=1)),
    "compression-float32": ("float32", dict(grad_compression=True)),
    "plain-bfloat16": ("bfloat16", dict()),
    "microbatch-bfloat16": ("bfloat16", dict(microbatch=1)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_reference_jitted_step(case):
    dtype, kw = STEP_CASES[case]
    tol = TOL32 if dtype == "float32" else TOL_BF16
    jcfg, cfg = _cfgs(dtype)
    compress = kw.get("grad_compression", False)
    jstate = jax.jit(lambda k: jts.make_train_state(
        k, jcfg, jopt.OptimizerConfig(), grad_compression=compress))(
            jax.random.PRNGKey(0))
    state = convert.import_reference_train_state(
        jax.tree_util.tree_map(np.asarray, jstate), cfg)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    tokens = _tokens(cfg)
    jopt_cfg = jopt.OptimizerConfig(lr=LR, warmup_steps=10)
    jnew, jmet = jax.jit(jts.make_train_step(jcfg, JCTX, jopt_cfg, **kw))(
        jstate, {"tokens": jnp.asarray(tokens)})
    new, met = ts.make_train_step(
        cfg, CTX, OptimizerConfig(lr=LR, warmup_steps=10), **kw)(
            state, {"tokens": torch.from_numpy(tokens)})

    assert int(new["step"]) == int(jnew["step"]) == 1
    assert new["step"].dtype == torch.int32
    assert set(met) == {"ce", "aux", "loss", "grad_norm", "lr"}
    for k in ("ce", "loss", "grad_norm"):
        want = float(jmet[k])
        assert abs(met[k].item() - want) <= tol * abs(want), (k, met[k], want)
    assert met["lr"].item() == float(jmet["lr"])

    jtrees = {k: _jflat(v) for k, v in _trees(jnew).items()}
    trees = {k: _ref_layout(v) for k, v in _trees(new).items()}
    assert set(trees) == set(jtrees)
    for k in ("params", "mu", "nu"):
        out, total = _outside(trees[k], jtrees[k],
                              lambda n, w: tol * np.abs(w).max())
        assert out <= FLIP_BUDGET * total, (k, out, total)
    if compress:
        # err = g + e - dequant(quant(g + e)): the gradient's own
        # tolerance plus one bf16 rounding of err; where an int8 rounding
        # flips, the two differ by one quantization step
        _, _, jg = _ref_grads(jstate["params"], tokens, jcfg)
        g = _jflat(jg)
        out, total = _outside(trees["err"], jtrees["err"], lambda n, w: (
            tol * np.abs(g[n]).max() + np.abs(w) * 2.0 ** -8))
        assert out <= FLIP_BUDGET * total, (out, total)
        steps = {n: np.abs(g[n]).max() / 127 for n in g}
        out, _ = _outside(trees["err"], jtrees["err"],
                          lambda n, w: 1.01 * steps[n] + np.abs(w) * 2 ** -8)
        assert out == 0


# --------------------------------------------------------------- int8 bits
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, scale", [((64,), 1.0), ((37, 129), 1e-3),
                                          ((5, 7, 11), 50.0)])
def test_quantize_int8_bit_for_bit(dtype, shape, scale):
    x = (scale * np.random.RandomState(len(shape)).randn(*shape)) \
        .astype(np.float32)
    x.flat[:4] = [0.5, -0.5, 1.5, -2.5]   # halves: round half to even
    jx = jnp.asarray(x).astype(dtype)
    jq, js = jax.jit(jcomp.quantize_int8)(jx)
    q, s = comp.quantize_int8(convert.to_tensor(jx))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(
        comp.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compressed_gradients_equal_the_reference_bit_for_bit(grads_pair):
    """The same gradients and error buffer through both: the stacked
    layers share one scale in the reference, and so in the port. The
    dequantized gradients equal the jitted reference's bit for bit, the
    error buffer the reference's arithmetic as written (unjitted): XLA
    contracts its ``g - q * scale`` into one FMA, which moves a few
    elements of the bf16 buffer by up to one bf16 step (2^-7 of the
    binade) at the buffer's largest value."""
    g = grads_pair
    rng = np.random.RandomState(3)
    jerr = jax.tree_util.tree_map(
        lambda a: jnp.asarray(1e-3 * rng.randn(*a.shape), jnp.bfloat16),
        g["jg"])
    jd, je_jit = jax.jit(jcomp.compress_grads_with_feedback)(g["jg"], jerr)
    _, je = jcomp.compress_grads_with_feedback(g["jg"], jerr)
    tg = convert.import_reference_params(
        jax.tree_util.tree_map(np.asarray, g["jg"]), g["cfg"])
    terr = convert.import_reference_params(
        jax.tree_util.tree_map(np.asarray, jerr), g["cfg"])
    d, e = comp.compress_grads_with_feedback(tg, terr)
    for got, want in ((d, jd), (e, je)):
        got, want = _ref_layout(got), _jflat(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    got, want = _ref_layout(e), _jflat(je_jit)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=2.0 ** -7 * np.abs(w).max(),
                                   err_msg=name)
    assert tree.leaves(e)[0].dtype == torch.bfloat16
    assert tree.leaves(d)[0].dtype == tree.leaves(tg)[0].dtype


def test_gradient_compression_error_feedback():
    """tests/test_distributed.py's error-feedback test on the port."""
    g = {"w": torch.linspace(-1.0, 1.0, 64).reshape(8, 8)}
    err = comp.init_error_buffer(g, dtype="float32")
    total_true = np.zeros((8, 8))
    total_sent = np.zeros((8, 8))
    for _ in range(20):
        sent, err = comp.compress_grads_with_feedback(g, err)
        total_true += g["w"].numpy()
        total_sent += sent["w"].numpy()
    rel = np.abs(total_sent - total_true).max() / np.abs(total_true).max()
    assert rel < 0.02, rel


# ------------------------------------------------------------ state shapes
def _shapes_in_ref_layout(port_state) -> dict:
    """name -> (shape, dtype name) with the layers stacked as the
    reference stacks them, read from meta tensors."""
    def stacked(t):
        layers = t["layers"]
        out = {f"{k}": (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in t.items() if k != "layers"}
        for part, leaves in layers[0].items():
            for name, v in leaves.items():
                out[f"stage0/layer0/{part}/{name}"] = (
                    (len(layers),) + tuple(v.shape),
                    str(v.dtype).split(".")[-1])
        return out
    out = {}
    for key, t in _trees(port_state).items():
        for name, sd in stacked(t).items():
            out[f"{key}/{name}"] = sd
    out["step"] = ((), str(port_state["step"].dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", [a + "-smoke" for a in DENSE] +
                         ["qwen2-7b"])
def test_train_state_shapes_match_reference_on_meta(arch):
    compress = arch.startswith("qwen2")
    jshapes = jts.make_train_state_shapes(
        jget_config(arch), jopt.OptimizerConfig(), grad_compression=compress)
    shapes = ts.make_train_state_shapes(
        get_config(arch), OptimizerConfig(), grad_compression=compress)
    for leaf in tree.leaves(shapes):
        assert leaf.is_meta, arch           # no memory behind any leaf
    got = _shapes_in_ref_layout(shapes)
    want = {}
    for key, t in _trees(jshapes).items():
        for name, sd in tree.flatten_with_names(t).items():
            want[f"{key}/{name}"] = (tuple(sd.shape), str(sd.dtype))
    want["step"] = ((), str(jshapes["step"].dtype))
    assert got == want


# ---------------------------------------------------------------- launcher
def _launch(ckpt, steps, *extra):
    return launch.main(["--device", "cpu", "--batch", "2", "--seq", "16",
                        "--steps", str(steps), "--ckpt-every", "3",
                        "--ckpt", str(ckpt), *extra])


def test_launcher_resumed_run_equals_an_uninterrupted_one(tmp_path, capsys):
    assert _launch(tmp_path / "a", 6) == 0
    assert _launch(tmp_path / "a", 9) == 0
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step    9 loss=" in out
    assert _launch(tmp_path / "b", 9) == 0
    a, _ = restore_pytree(os.path.join(tmp_path / "a", "step_9"))
    b, _ = restore_pytree(os.path.join(tmp_path / "b", "step_9"))
    assert set(a) == set(b) and "step" in a and int(a["step"]) == 9
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name
    assert sorted(os.listdir(tmp_path / "a")) == ["step_6", "step_9"]


def test_launcher_refuses_a_mesh_and_a_missing_card(tmp_path, capsys,
                                                    monkeypatch):
    assert _launch(tmp_path, 1, "--data-parallel", "2") == 2
    assert "no mesh" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch.main(["--steps", "1", "--ckpt", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_launcher_batches_are_the_reference_launchers():
    batches = launch.token_batches(256, 4, 64)
    rng = np.random.RandomState(1)
    for _ in range(3):
        want = rng.randint(0, 256, size=(4, 65)).astype(np.int32)
        np.testing.assert_array_equal(next(batches), want)


# ------------------------------------------------------------ dense smokes
@pytest.mark.parametrize("arch", DENSE)
def test_arch_smoke_forward_and_train_step(arch):
    """tests/test_models.py's per-arch smoke test on the port's dense
    configs: one step, finite loss, parameters moved and finite."""
    cfg = get_config(arch).reduced()
    ctx = L.ModelContext(q_chunk=32, k_chunk=32)
    state = ts.make_train_state(torch.Generator().manual_seed(0), cfg,
                                OptimizerConfig())
    step = ts.make_train_step(cfg, ctx, OptimizerConfig())
    tokens = torch.from_numpy(_tokens(cfg, seed=0, b=2, s=24))
    state2, metrics = step(state, {"tokens": tokens})
    assert np.isfinite(metrics["loss"].item()), arch
    assert int(state2["step"]) == 1
    delta = [(a.float() - b.float()).abs().max().item() for a, b in
             zip(tree.leaves(state["params"]), tree.leaves(state2["params"]))]
    assert max(delta) > 0
    for leaf in tree.leaves(state2["params"]):
        assert torch.isfinite(leaf.float()).all(), arch
