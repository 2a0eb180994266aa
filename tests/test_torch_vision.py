"""The port's ViT (``repro_torch.models.vision``) against the reference's
on the CPU, at tests/test_system.py's size (2 layers, d 64, 2 heads of
32, d_ff 128, 4 classes; 64x64 images, patch 8, so 64 patches).

The reference's parameters reach the port through
``convert.import_reference_vit_params``; images and labels come from a
numpy seed. Both attention loops run in 16-row chunks (several q and KV
blocks). Tolerances: patches, logits, loss and accuracy within
rtol = atol = 1e-5; every gradient leaf against ``jax.grad`` of the
reference's ``loss_fn`` within rtol 1e-4, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import vision as jvision
from repro_torch import tree
from repro_torch.device import use_device
from repro_torch.models import convert, vision
from repro_torch.models.layers import ModelContext

CHUNK = 16
JCTX = JL.ModelContext(q_chunk=CHUNK, k_chunk=CHUNK)
CTX = ModelContext(q_chunk=CHUNK, k_chunk=CHUNK)
SIZE = dict(num_classes=4, num_layers=2, d_model=64, num_heads=2,
            num_kv_heads=2, head_dim=32, d_ff=128)
B = 6
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


class ViT:
    def __init__(self):
        self.jcfg = jvision.ViTConfig(**SIZE)
        self.cfg = vision.ViTConfig(**SIZE)
        self.jparams = jax.jit(jvision.init, static_argnums=1)(
            jax.random.PRNGKey(3), self.jcfg)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.params = convert.import_reference_vit_params(self.np_params,
                                                          self.cfg)
        rng = np.random.RandomState(11)
        self.images = rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8)
        self.labels = rng.randint(0, 4, B).astype(np.int32)
        self.jbatch = {"image": jnp.asarray(self.images),
                       "label": jnp.asarray(self.labels)}
        self.batch = {"image": torch.from_numpy(self.images),
                      "label": torch.from_numpy(self.labels)}
        jcfg = self.jcfg
        self.jforward = jax.jit(
            lambda p, x: jvision.forward(p, x, jcfg, JCTX))
        self.jloss = jax.jit(
            lambda p, b: jvision.loss_fn(p, b, jcfg, JCTX))
        self.jgrad = jax.jit(jax.grad(
            lambda p, b: jvision.loss_fn(p, b, jcfg, JCTX)[0]))


@pytest.fixture(scope="module")
def vit():
    return ViT()


def _close(got, want, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def test_converter_maps_every_leaf_bit_for_bit(vit):
    want = tree.flatten_with_names(vit.np_params)
    got = tree.flatten_with_names(vit.params)
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert got[name].dtype == torch.float32, name
        assert np.array_equal(got[name].numpy(), leaf), name


def test_converter_refuses_a_tree_of_another_depth(vit):
    deeper = vision.ViTConfig(**dict(SIZE, num_layers=3))
    with pytest.raises(ValueError, match="layer2"):
        convert.import_reference_vit_params(vit.np_params, deeper)


def test_init_has_the_reference_leaves_shapes_and_dtypes(vit):
    with use_device("cpu"):
        params = vision.init(torch.Generator().manual_seed(0), vit.cfg)
    got = tree.flatten_with_names(params)
    want = tree.flatten_with_names(vit.np_params)
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for n, t in got.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}


def test_patchify_matches_reference(vit):
    got = vision.patchify(vit.batch["image"], vit.cfg.patch)
    want = jvision.patchify(vit.jbatch["image"], vit.jcfg.patch)
    assert tuple(got.shape) == (B, 64, 192) == tuple(want.shape)
    _close(got.numpy(), want)


def test_forward_logits_match_reference(vit):
    got = vision.forward(vit.params, vit.batch["image"], vit.cfg, CTX)
    want = vit.jforward(vit.jparams, vit.jbatch["image"])
    assert tuple(got.shape) == (B, 4)
    _close(got.numpy(), want)


def test_loss_and_accuracy_match_reference(vit):
    loss, metrics = vision.loss_fn(vit.params, vit.batch, vit.cfg, CTX)
    jloss, jmetrics = vit.jloss(vit.jparams, vit.jbatch)
    _close(loss.item(), jloss)
    _close(metrics["acc"].item(), jmetrics["acc"])
    assert metrics["loss"] is loss


def test_every_gradient_leaf_matches_jax_grad(vit):
    leaves = tree.tree_map(lambda p: p.clone().requires_grad_(),
                           vit.params)
    loss, _ = vision.loss_fn(leaves, vit.batch, vit.cfg, CTX)
    loss.backward()
    want = tree.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, vit.jgrad(vit.jparams,
                                                     vit.jbatch)))
    got = tree.flatten_with_names(leaves)
    assert list(got) == list(want)
    for name, g in want.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(got[name].grad.numpy(), g,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_the_flash_route_off_the_card_is_the_chunked_loop(vit):
    """On the CPU ``ctx.flash_kernel`` changes nothing: both settings run
    the reference's chunked loop, so the logits are equal."""
    import dataclasses
    a = vision.forward(vit.params, vit.batch["image"], vit.cfg, CTX)
    b = vision.forward(vit.params, vit.batch["image"], vit.cfg,
                       dataclasses.replace(CTX, flash_kernel=False))
    assert torch.equal(a, b)
