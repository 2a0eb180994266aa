"""End-to-end training on the port, on the CPU: JPEG corpus -> the port's
multi-worker loader -> ViT training with AdamW -> checkpoint and restart.

The first two tests mirror tests/test_system.py's
``test_end_to_end_training_learns`` and
``test_checkpoint_restart_mid_training`` under ``use_device("cpu")``,
with the same corpora, sizes, optimizer settings and bars. The others
drive the port's trainer (``repro_torch.train.vision_pipeline``): a run
cut by a restart ends where an uninterrupted run ends, and ``main``
trains and resumes from its own checkpoint directory.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.loader import DataLoader, LoaderConfig
from repro_torch.device import use_device
from repro_torch.jpeg.corpus import build_corpus
from repro_torch.models import vision
from repro_torch.models.layers import ModelContext
from repro_torch.train import vision_pipeline as vp
from repro_torch.train.optimizer import OptimizerConfig

CPU = torch.device("cpu")
CTX = ModelContext(q_chunk=64, k_chunk=64)
OPT = OptimizerConfig(lr=3e-3, warmup_steps=5)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with use_device("cpu"):
        yield


def _train(state, loader, cfg, steps):
    losses = []
    done = 0
    while done < steps:
        for batch in loader:
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            state, metrics = vp.train_step(state, batch, cfg, OPT, CTX)
            losses.append(float(metrics["loss"]))
            done += 1
            if done >= steps:
                break
    return state, losses


def test_end_to_end_training_learns():
    corpus = build_corpus(48, seed=11, num_classes=4)
    cfg = vision.ViTConfig(num_classes=4, num_layers=2, d_model=64,
                           num_heads=2, num_kv_heads=2, head_dim=32,
                           d_ff=128)
    state = vp.init_state(cfg, 0, CPU)
    loader = DataLoader(corpus.files, corpus.labels,
                        cfg=LoaderConfig(batch_size=16, num_workers=2),
                        path_name="numpy-fast")
    state, losses = _train(state, loader, cfg, steps=30)
    assert np.isfinite(losses).all()
    # memorizing 48 images x 4 labels: loss must drop substantially
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, \
        (np.mean(losses[:5]), np.mean(losses[-5:]))
    assert int(state["step"]) == 30


def test_checkpoint_restart_mid_training(tmp_path):
    corpus = build_corpus(24, seed=13, num_classes=3)
    cfg = vision.ViTConfig(num_classes=3, num_layers=1, d_model=64,
                           num_heads=2, num_kv_heads=2, head_dim=32,
                           d_ff=128)
    state = vp.init_state(cfg, 1, CPU)
    loader = DataLoader(corpus.files, corpus.labels,
                        cfg=LoaderConfig(batch_size=12),
                        path_name="numpy-fast")
    state, _ = _train(state, loader, cfg, steps=4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, extra={"loader": loader.state()})

    # "node failure": rebuild everything from disk
    like = vp.init_state(cfg, 1, CPU)
    step, restored, extra = mgr.restore_latest(like=like)
    assert step == 4
    _, ref_tree, _ = mgr.restore_latest()
    assert sorted(ref_tree) == sorted(tree.flatten_with_names(like))
    loader2 = DataLoader(corpus.files, corpus.labels,
                         cfg=LoaderConfig(batch_size=12),
                         path_name="numpy-fast")
    loader2.restore(extra["loader"])
    state2, losses = _train(restored, loader2, cfg, steps=3)
    assert int(state2["step"]) == 7
    assert np.isfinite(losses).all()


SMALL = vision.ViTConfig(num_classes=3, num_layers=1, d_model=64,
                         num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128)


def _pipeline_loader(corpus):
    return DataLoader(corpus.files, corpus.labels,
                      cfg=LoaderConfig(batch_size=8, num_workers=2,
                                       decode_batch=4, shuffle=True,
                                       drop_remainder=True),
                      path_name="cuda-batch")


def test_a_restarted_run_ends_where_an_uninterrupted_run_ends(tmp_path):
    """The trainer saves asynchronously at step 2 and at its end (3);
    a new loader and state from ``restore_latest`` train on to step 6.
    Every batch after the restart is the one an uninterrupted run
    trains on, and the parameters end equal, bit for bit: the saved
    loader state is the one after the last batch trained on, not the
    loader's own cursor, which ``prefetch_to_device`` runs ahead."""
    corpus = build_corpus(20, seed=3, num_classes=3)
    straight, whole = vp.train(vp.init_state(SMALL, 2, CPU),
                               _pipeline_loader(corpus), steps=6,
                               cfg=SMALL)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    _, first = vp.train(vp.init_state(SMALL, 2, CPU),
                        _pipeline_loader(corpus), steps=3, cfg=SMALL,
                        mgr=mgr, save_every=2)
    assert mgr.steps() == [2, 3]
    step, state, extra = mgr.restore_latest(
        like=vp.init_state(SMALL, 9, CPU))
    assert step == 3 and int(state["step"]) == 3
    loader = _pipeline_loader(corpus)
    loader.restore(extra["loader"])
    state, second = vp.train(state, loader, steps=6, cfg=SMALL)
    assert int(state["step"]) == 6
    labels = first["labels"] + second["labels"]
    assert len(labels) == len(whole["labels"]) == 6
    for step, (got, want) in enumerate(zip(labels, whole["labels"])):
        assert np.array_equal(got, want), step
    np.testing.assert_array_equal(first["losses"] + second["losses"],
                                  whole["losses"])
    for name, t in tree.flatten_with_names(straight).items():
        assert torch.equal(tree.flatten_with_names(state)[name], t), name
    assert 0.0 <= whole["share"] <= 1.0
    assert whole["data_s"] >= 0.0 and whole["step_s"] > 0.0


def test_main_trains_then_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--device", "cpu", "--model", "small", "--corpus", "16",
            "--ckpt", str(tmp_path)]
    out = vp.main(args + ["--steps", "2"])
    assert out["step"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert out["workers"] in (0, 2, 4)
    again = vp.main(args + ["--steps", "3"])
    assert again["step"] == 3 and len(again["losses"]) == 1
    printed = capsys.readouterr().out
    assert "resumed from step 2" in printed
    assert "input-pipeline share" in printed
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3]
