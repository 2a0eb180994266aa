"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's on the CPU: the same parameters and, at each of three
steps, the same gradients (numpy seeds) through both. Parameters,
moments, ``grad_norm`` and ``lr`` within rtol 1e-6, with clipping
active and inactive and during and after the warmup.

Each leaf also gets an atol of 1e-6 of its largest |value|: where
``b1 * mu + (1 - b1) * g`` nearly cancels, float32 rounding (XLA may
fuse the sum into one FMA) leaves a relative error far above 1e-6 on
a near-zero element. Measured (``clipped_warmup``, step 2, ``mu/w``):
at most 7.5e-9 absolute and 3.1e-6 relative, against a largest |value|
of 0.053.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import tree
from repro_torch.train import optimizer as opt

RTOL = 1e-6
SHAPES = {"w": (6, 5), "b": (5,), "layer0": {"attn": {"wq": (5, 4)},
                                             "ffn": {"ln": (4,)}}}


def _draw(shapes, rng, scale):
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, scale) for k, v in sorted(shapes.items())}
    return (scale * rng.randn(*shapes)).astype(np.float32)


def _torch(t):
    return tree.tree_map(lambda a: torch.from_numpy(a.copy()), t)


def _jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _assert_trees(got, want, what):
    want = tree.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, want))
    got = tree.flatten_with_names(got)
    assert list(got) == list(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


CASES = {
    # grads of norm ~10 against clip 1: every step clipped, in warmup
    "clipped_warmup": (jopt.OptimizerConfig(lr=1e-2, warmup_steps=5), 3.0),
    # no clipping (clip far above the norm), warmup over after step 0
    "unclipped": (jopt.OptimizerConfig(lr=3e-3, clip_norm=1e3,
                                       warmup_steps=1), 0.5),
    # the example's settings
    "example": (jopt.OptimizerConfig(lr=1e-3, warmup_steps=20), 0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_reference(case):
    jcfg, gscale = CASES[case]
    cfg = opt.OptimizerConfig(**jcfg.__dict__)
    params_np = _draw(SHAPES, np.random.RandomState(0), 1.0)
    jparams, params = _jax(params_np), _torch(params_np)
    jstate, state = jopt.adamw_init(jparams), opt.adamw_init(params)
    jupdate = jax.jit(lambda g, s, p, t: jopt.adamw_update(g, s, p, t, jcfg))
    clipped = []
    for step in range(3):
        grads_np = _draw(SHAPES, np.random.RandomState(10 + step), gscale)
        jparams, jstate, jm = jupdate(_jax(grads_np), jstate, jparams,
                                      jnp.int32(step))
        params, state, m = opt.adamw_update(
            _torch(grads_np), state, params,
            torch.tensor(step, dtype=torch.int32), cfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=RTOL, err_msg=key)
        _assert_trees(params, jparams, f"step {step} params")
        _assert_trees(state["mu"], jstate["mu"], f"step {step} mu")
        _assert_trees(state["nu"], jstate["nu"], f"step {step} nu")
        clipped.append(m["grad_norm"].item() > cfg.clip_norm)
    assert all(clipped) if case == "clipped_warmup" else not any(clipped)


def test_warmup_schedule_matches_reference():
    jcfg = jopt.OptimizerConfig(lr=2e-3, warmup_steps=7)
    cfg = opt.OptimizerConfig(**jcfg.__dict__)
    for step in (0, 1, 5, 6, 7, 100):
        got = opt.schedule(torch.tensor(step, dtype=torch.int32), cfg)
        np.testing.assert_allclose(
            got.item(), float(jopt.schedule(jnp.int32(step), jcfg)),
            rtol=RTOL)
    assert opt.schedule(torch.tensor(100), cfg).item() == pytest.approx(2e-3)


def test_moments_keep_their_dtype_and_the_update_returns_new_tensors():
    params = _torch(_draw(SHAPES, np.random.RandomState(1), 1.0))
    before = tree.tree_map(torch.clone, params)
    state = opt.adamw_init(params, opt_dtype="bfloat16")
    grads = _torch(_draw(SHAPES, np.random.RandomState(2), 1.0))
    new, state, _ = opt.adamw_update(grads, state, params,
                                     torch.tensor(0, dtype=torch.int32),
                                     opt.OptimizerConfig())
    for name, t in tree.flatten_with_names(state).items():
        assert t.dtype == torch.bfloat16, name
    for name, t in tree.flatten_with_names(new).items():
        assert t.dtype == torch.float32 and not t.requires_grad, name
    for (name, p), b in zip(tree.flatten_with_names(params).items(),
                            tree.leaves(before)):
        assert torch.equal(p, b), f"{name} changed in place"
