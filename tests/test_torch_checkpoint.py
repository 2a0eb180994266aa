"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: a round
trip, the same leaves and bytes as the reference's ``save_pytree`` of the
same state, atomicity under a failed write, rolling GC, async errors
and numpy scalars in the loader's extras.

The port's manifest is ``manifest.json`` where the reference writes
``manifest.msgpack`` (msgpack is not among the port's dependencies); the
two are compared key by key.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager, manager
from repro_torch.checkpoint import restore_pytree, save_pytree

LOADER = {"epoch": 2, "cursor": 17, "skips": [[4, "UnsupportedJpeg: x"]],
          "seed": 0}


def _numpy_state(seed=0):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    params = {"patch_proj": f32(12, 8), "head": f32(8, 3),
              "layer0": {"attn": {"wq": f32(8, 8), "ln": f32(8)},
                         "ffn": {"w1": f32(8, 16)}},
              "emb_bf16": f32(4, 8).astype(ml_dtypes.bfloat16)}
    zeros = lambda a: np.zeros_like(a)
    opt = {"mu": tree.tree_map(zeros, params),
           "nu": tree.tree_map(lambda a: np.abs(a) + 1, params)}
    return {"params": params, "opt": opt, "step": np.int32(5 + seed)}


def _as_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _torch_state(seed=0):
    return tree.tree_map(_as_torch, _numpy_state(seed))


def _jax_state(seed=0):
    return tree.tree_map(jnp.asarray, _numpy_state(seed))


def _assert_equal_states(got, want):
    got, want = tree.flatten_with_names(got), tree.flatten_with_names(want)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape \
            and g.device == w.device, name
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w), name


def test_round_trip_restores_values_dtypes_and_extras(tmp_path):
    state = _torch_state()
    save_pytree(state, str(tmp_path / "ck"), extra={"loader": LOADER})
    like = tree.tree_map(torch.zeros_like, _torch_state(1))
    restored, extra = restore_pytree(str(tmp_path / "ck"), like=like)
    _assert_equal_states(restored, state)
    assert extra == {"loader": LOADER}
    flat, _ = restore_pytree(str(tmp_path / "ck"))
    assert sorted(flat) == sorted(tree.flatten_with_names(state))
    assert isinstance(flat["params/head"], np.ndarray)


def test_restore_follows_like_dtypes(tmp_path):
    """``like`` decides the dtype a leaf comes back in."""
    state = _torch_state()
    save_pytree(state, str(tmp_path / "ck"))
    like = tree.tree_map(lambda t: t.to(torch.float64), state)
    restored, _ = restore_pytree(str(tmp_path / "ck"), like=like)
    for name, t in tree.flatten_with_names(restored).items():
        assert t.dtype == torch.float64, name
    np.testing.assert_array_equal(restored["params"]["head"].numpy(),
                                  state["params"]["head"].double().numpy())


def test_leaves_match_the_reference_checkpoint(tmp_path):
    ref_mgr = jmanager.CheckpointManager(str(tmp_path / "ref"))
    ref_mgr.save(5, _jax_state(), extra={"loader": LOADER})
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(5, _torch_state(), extra={"loader": LOADER})
    assert ref_mgr.steps() == mgr.steps() == [5]
    ref_dir, dir_ = tmp_path / "ref" / "step_5", tmp_path / "port" / "step_5"
    with open(ref_dir / "manifest.msgpack", "rb") as f:
        want = msgpack.unpackb(f.read())
    with open(dir_ / "manifest.json") as f:
        got = json.load(f)
    assert got["leaves"] == want["leaves"]
    assert "params/emb_bf16" in got["leaves"] and \
        got["leaves"]["params/emb_bf16"]["dtype"] == "bfloat16"
    want_extra = dict(want["extra"])
    got_extra = dict(got["extra"])
    assert isinstance(got_extra.pop("time"), float)
    want_extra.pop("time")
    assert got_extra == want_extra == {"loader": LOADER, "step": 5}
    for name, meta in want["leaves"].items():
        a = np.load(ref_dir / meta["file"])
        b = np.load(dir_ / meta["file"])
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes(), name


def test_a_failed_write_leaves_the_last_good_step(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _torch_state(0))
    calls = {"n": 0}
    real = np.save

    def crash_on_third(f, arr):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk full")
        return real(f, arr)
    monkeypatch.setattr(manager.np, "save", crash_on_third)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, _torch_state(1))
    assert mgr.steps() == [1]
    assert os.path.isdir(tmp_path / "step_2.tmp")
    step, restored, _ = mgr.restore_latest(
        like=tree.tree_map(torch.zeros_like, _torch_state()))
    assert step == 1
    _assert_equal_states(restored, _torch_state(0))


def test_gc_keeps_the_newest_keep_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save_async(step, _torch_state(step))
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    step, restored, _ = mgr.restore_latest(
        like=tree.tree_map(torch.zeros_like, _torch_state()))
    assert step == 4 and int(restored["step"]) == 9


def test_an_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def refuse(*a, **kw):
        raise OSError("read-only file system")
    monkeypatch.setattr(manager, "save_pytree", refuse)
    mgr.save_async(3, _torch_state())          # does not raise here
    with pytest.raises(OSError, match="read-only"):
        mgr.wait()
    mgr.wait()                                 # raised once, then clear
    assert mgr.steps() == []


def test_the_async_snapshot_is_taken_before_save_returns(tmp_path):
    """Training goes on while the write runs: a leaf changed in place
    after ``save_async`` returns must not reach the file."""
    state = _torch_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, state)
    state["params"]["head"].add_(100.0)
    mgr.wait()
    _, restored, _ = mgr.restore_latest(
        like=tree.tree_map(torch.zeros_like, state))
    _assert_equal_states(restored, _torch_state())


def test_numpy_scalars_in_the_extras_become_plain_values(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    loader = {"epoch": np.int64(3), "cursor": np.int32(7),
              "rate": np.float32(0.5), "order": np.arange(3),
              "skips": [(np.int64(4), "CorruptJpeg")]}
    mgr.save(1, _torch_state(), extra={"loader": loader})
    _, _, extra = mgr.restore_latest()
    assert extra["loader"] == {"epoch": 3, "cursor": 7, "rate": 0.5,
                               "order": [0, 1, 2],
                               "skips": [[4, "CorruptJpeg"]]}
    assert type(extra["loader"]["epoch"]) is int
    with pytest.raises(TypeError, match="set"):
        mgr.save(2, _torch_state(), extra={"bad": {1, 2}})
    assert mgr.steps() == [1]
