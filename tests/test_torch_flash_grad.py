"""The gradient of ``ops.flash_attention`` on the CPU.

With grad enabled and an input that requires grad, the wrapper goes
through ``ops._FlashAttention``: its forward is the wrapper's own call
(on the CPU, the plain version ``ref.flash_attention``), its backward
the float32 attention gradient ``ops._flash_attention_grad``. Held
against autograd through ``ref.flash_attention`` on the same inputs:
causal and full, GQA (4 query heads over 2 KV heads) and plain
multi-head, float32 within rtol = atol = 1e-5 and bfloat16 within one
bf16 rounding step of the gradients (rtol = atol = 2e-2, the flash
kernel's bf16 tolerance in tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(B, S, H, KV, D, dtype, seed):
    rng = np.random.RandomState(seed)
    mk = lambda n, std: (torch.from_numpy(
        (std * rng.randn(B, S, n, D)).astype(np.float32)).to(dtype)
        .requires_grad_())
    q, k, v = mk(H, 2.0), mk(KV, 2.0), mk(KV, 1.0)
    dout = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)) \
        .to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gradient_matches_autograd_through_the_plain_version(
        causal, heads, dtype):
    H, KV = heads
    q, k, v, dout = _inputs(2, 19, H, KV, 16, dtype, seed=H + KV + causal)
    out = ops.flash_attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), dout)
    want_out = ref.flash_attention(q, k, v, causal)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    assert torch.equal(out, want_out)
    tol = TOL[dtype]
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert w.float().abs().max() > 10 * tol, name
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=tol, atol=tol, err_msg=f"d{name}")


def test_backward_never_calls_the_plain_version(monkeypatch):
    """The backward is its own math: with ``ref.flash_attention`` made to
    raise after the forward, the gradients still come."""
    q, k, v, dout = _inputs(1, 8, 4, 2, 16, torch.float32, seed=0)
    out = ops.flash_attention(q, k, v, causal=True)

    def refuse(*a, **kw):
        raise AssertionError("the backward called ref.flash_attention")
    monkeypatch.setattr(ref, "flash_attention", refuse)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_without_grad_the_call_has_no_graph():
    q, k, v, _ = _inputs(1, 8, 2, 2, 16, torch.float32, seed=1)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    plain = [t.detach() for t in (q, k, v)]
    assert ops.flash_attention(*plain).grad_fn is None


def test_gradient_reaches_only_the_inputs_that_require_it():
    q, k, v, dout = _inputs(1, 8, 2, 2, 16, torch.float32, seed=2)
    k, v = k.detach(), v.detach()
    out = ops.flash_attention(q, k, v, causal=False)
    (dq,) = torch.autograd.grad(out, (q,), dout)
    want = torch.autograd.grad(ref.flash_attention(q, k, v, False), (q,),
                               dout)[0]
    np.testing.assert_allclose(dq.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
