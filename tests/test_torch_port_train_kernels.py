"""The port's kernel gradients against the JAX package's, on the CPU.

The port's attention and loss `torch.autograd.Function`s run their plain
versions here: the plain attention forward and `mha_attention_bwd_plain`
(`_bwd_kernel`'s formulas), and the loss's closed-form backward.  They are
held against `jax.grad` through the Pallas kernels in interpret mode (the
attention backward is then `_bwd_kernel` itself) at the tolerances of
tests/test_pallas_kernels.py.  The CUDA kernels are held against the same
plain versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.ops.pallas.attention import mha_attention as jax_mha
from peppa_tpu.ops.pallas.loss import fused_triplet_loss as jax_fused_loss
from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                mha_attention_bwd,
                                                mha_attention_bwd_plain,
                                                mha_attention_plain)
from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss
from peppa_tpu_torch.ops.loss import triplet_loss


def _jax_attention_grads(q, k, v, lengths, dtype):
    lens = None if lengths is None else jnp.asarray(lengths)

    def f(q, k, v):
        out = jax_mha(q, k, v, lengths=lens, interpret=True)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g, np.float32)
            for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_attention_grads(q, k, v, lengths, dtype):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    lens = None if lengths is None else torch.from_numpy(lengths)
    out = mha_attention(*args, lengths=lens)
    assert out.dtype == dtype
    torch.sum(torch.square(out.float())).backward()
    for x in args:
        assert x.grad.dtype == dtype
    return [x.grad.float().numpy() for x in args]


@pytest.mark.parametrize("lengths", [None, (48, 17)], ids=["full", "ragged"])
def test_attention_grads_match_pallas(rng, lengths):
    """(2, 48, 2, 16) float32 at rtol/atol 1e-4, as
    tests/test_pallas_kernels.py::test_attention_grads_match_reference."""
    q, k, v = (rng.normal(size=(2, 48, 2, 16)).astype(np.float32)
               for _ in range(3))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = _jax_attention_grads(q, k, v, lens, jnp.float32)
    got = _port_attention_grads(q, k, v, lens, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    if lens is not None:  # masked keys: exactly zero dK and dV
        assert not got[1][1, 17:].any() and not got[2][1, 17:].any()


def test_attention_grads_bf16_match_pallas(rng):
    q, k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = _jax_attention_grads(q, k, v, None, jnp.bfloat16)
    got = _port_attention_grads(q, k, v, None, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("lengths", [None, (9, 4, 1, 0)],
                         ids=["full", "ragged_with_zero"])
def test_attention_bwd_plain_is_the_forward_gradient(rng, lengths):
    """`_bwd_kernel`'s formulas are the gradient of the plain forward, also
    at length 0 (P uniform over T, dQ = dK = 0)."""
    q, k, v, do = (torch.from_numpy(rng.normal(size=(4, 9, 3, 16))
                                    .astype(np.float32)) for _ in range(4))
    lens = None if lengths is None else torch.tensor(lengths)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(mha_attention_plain(*qkv, lens), qkv, do)
    got = mha_attention_bwd_plain(q, k, v, do, lens)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # on the CPU the entry point is the plain version; `lse` and `out`,
    # which the card's kernel reads, are ignored
    out = mha_attention_plain(q, k, v, lens)
    assert torch.equal(mha_attention_bwd(q, k, v, do, lens)[0], got[0])
    assert torch.equal(mha_attention_bwd(q, k, v, do, lens, out=out)[0],
                       got[0])


@pytest.mark.parametrize("lengths", [None, (9, 4, 1, 0)],
                         ids=["full", "ragged_with_zero"])
def test_attention_bwd_delta_from_the_output(rng, lengths):
    """The bf16 backward kernel takes D = rowsum(dO o O) from the forward's
    output where `_bwd_kernel` takes rowsum(dP o P): the two agree because
    O = P V.  At length 0 (P uniform) they agree too; the kernel's dS is 0
    there all the same."""
    q, k, v, do = (torch.from_numpy(rng.normal(size=(4, 9, 3, 16))
                                    .astype(np.float64)) for _ in range(4))
    lens = None if lengths is None else torch.tensor(lengths)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * 16 ** -0.5, k)
    if lens is not None:
        mask = torch.arange(9)[None, :] < lens[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)  # the forward, in float64
    torch.testing.assert_close(out.float(), mha_attention_plain(
        q.float(), k.float(), v.float(), lens), rtol=1e-5, atol=1e-6)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    want = torch.sum(dp * p, dim=-1)
    got = torch.einsum("bqhd,bqhd->bhq", do, out)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b,d", [(10, 64), (13, 100)])
def test_loss_grads_match_pallas(rng, b, d):
    """rtol 1e-4, atol 1e-6, as
    tests/test_pallas_kernels.py::test_fused_loss_grads_match_reference."""
    v = rng.normal(size=(b, d)).astype(np.float32)
    a = rng.normal(size=(b, d)).astype(np.float32)
    want = jax.grad(lambda v, a: jax_fused_loss(v, a, 0.2, True),
                    argnums=(0, 1))(jnp.asarray(v), jnp.asarray(a))
    tv, ta = (torch.from_numpy(x).requires_grad_() for x in (v, a))
    loss = fused_triplet_loss(tv, ta, 0.2)
    loss.backward()
    for g, w in zip((tv.grad, ta.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    # the dispatching entry point goes through the same Function
    tv2, ta2 = (torch.from_numpy(x).requires_grad_() for x in (v, a))
    triplet_loss(tv2, ta2).backward()
    torch.testing.assert_close(tv2.grad, tv.grad, rtol=0, atol=0)


def test_cpu_gradients_do_not_count_as_launches(rng):
    before = (mha_attention.launches, mha_attention_bwd.launches,
              fused_triplet_loss.launches)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    mha_attention(q, q, q).sum().backward()
    v = torch.randn(4, 8, requires_grad=True)
    fused_triplet_loss(v, v.flip(0)).backward()
    assert (mha_attention.launches, mha_attention_bwd.launches,
            fused_triplet_loss.launches) == before


def test_serving_never_takes_the_autograd_path(monkeypatch):
    """Under `inference_mode` (EncoderService, eval_step) attention is the
    forward alone: no Function, so the kernel writes no log-sum-exp."""
    from peppa_tpu_torch.ops.cuda import attention

    def refuse(*args):
        raise AssertionError("autograd path under inference_mode")

    monkeypatch.setattr(attention._Attention, "apply", refuse)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.inference_mode():
        assert not mha_attention(q, q, q).requires_grad
    with pytest.raises(AssertionError, match="autograd path"):
        mha_attention(q, q, q)
