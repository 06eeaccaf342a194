"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA card and skips without one.  The file imports
nothing of JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from peppa_tpu_torch.ops.cuda.attention import (_launch, mha_attention,
                                                mha_attention_bwd,
                                                mha_attention_bwd_plain,
                                                mha_attention_plain)
from peppa_tpu_torch.ops.cuda.loss import (fused_triplet_loss,
                                           fused_triplet_loss_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # backward, as chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,hd", [(64, 64), (77, 64), (316, 64), (40, 16),
                                  (50, 32)])
def test_attention_kernel_matches_plain(cuda, dtype, tol, t, hd):
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(4, t, 12, hd, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    lens = torch.tensor([t, t // 2, 3, 1], device=cuda)
    for lengths in (None, lens):
        before = mha_attention.launches
        got = mha_attention(q, k, v, lengths)
        assert mha_attention.launches == before + 1
        want = mha_attention_plain(q, k, v, lengths)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_attention_kernel_reads_strided_views(cuda, dtype, tol):
    """q/k/v as slices of one fused (B, T, 3, H, hd) projection, a
    head-major (B, H, T, hd) tensor seen as (B, T, H, hd), and k/v whose
    head dim is not contiguous (the kernel's element-wise load path)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 99, 3, 12, 64, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    heads_first = torch.randn(2, 12, 99, 64, generator=gen, device=cuda
                              ).to(dtype).transpose(1, 2)
    dim_strided = torch.randn(2, 2, 99, 64, 12, generator=gen, device=cuda
                              ).to(dtype).transpose(3, 4)
    for args in ((q, k, v), (heads_first, k, v),
                 (q, dim_strided[0], dim_strided[1])):
        got = mha_attention(*args)
        want = mha_attention_plain(*(x.contiguous() for x in args))
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b", [8, 13, 32, 1024])
def test_loss_kernel_matches_plain(cuda, b):
    gen = torch.Generator(device=cuda).manual_seed(0)
    v = torch.randn(b, 512, generator=gen, device=cuda)
    a = torch.randn(b, 512, generator=gen, device=cuda)
    before = fused_triplet_loss.launches
    got = fused_triplet_loss(v, a, 0.2)
    assert fused_triplet_loss.launches == before + 1
    want = fused_triplet_loss_plain(v, a, 0.2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_loss_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    v = torch.randn(777, 100, generator=gen, device=cuda)
    a = torch.randn(777, 100, generator=gen, device=cuda)
    first = fused_triplet_loss(v, a)
    assert all(torch.equal(first, fused_triplet_loss(v, a))
               for _ in range(5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [40, 77, 316])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_attention_bwd_kernel_matches_plain(cuda, dtype, t, hd):
    gen = torch.Generator(device=cuda).manual_seed(t * hd)
    q, k, v, do = (torch.randn(4, t, 12, hd, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    lens = torch.tensor([t, t // 2, 3, 1], device=cuda)
    for lengths in (None, lens):
        _, lse = _launch(q, k, v, lengths, hd ** -0.5, with_lse=True)
        before = mha_attention_bwd.launches
        got = mha_attention_bwd(q, k, v, do, lengths, lse=lse)
        assert mha_attention_bwd.launches == before + 1
        want = mha_attention_bwd_plain(q, k, v, do, lengths)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])
        if lengths is not None:  # masked keys: exactly zero dK and dV
            for g in got[1:]:
                assert not g[1, t // 2:].any() and not g[3, 1:].any()
        again = mha_attention_bwd(q, k, v, do, lengths, lse=lse)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_attention_bwd_kernel_length_zero(cuda):
    """Length 0 follows the forward (P uniform over T): dQ = dK = 0 and dV
    averages dO, as the plain version defines it."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(2, 50, 2, 32, generator=gen, device=cuda)
                   for _ in range(4))
    lens = torch.tensor([50, 0], device=cuda)
    _, lse = _launch(q, k, v, lens, 32 ** -0.5, with_lse=True)
    got = mha_attention_bwd(q, k, v, do, lens, lse=lse)
    want = mha_attention_bwd_plain(q, k, v, do, lens)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert not got[0][1].any() and not got[1][1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_autograd_runs_both_kernels(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 99, 12, 64, generator=gen, device=cuda)
               .to(dtype).requires_grad_() for _ in range(3))
    lens = torch.tensor([99, 40], device=cuda)
    do = torch.randn(2, 99, 12, 64, generator=gen, device=cuda).to(dtype)
    before = (mha_attention.launches, mha_attention_bwd.launches)
    out = mha_attention(q, k, v, lens)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (mha_attention.launches, mha_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = mha_attention_bwd_plain(q.detach(), k.detach(), v.detach(), do,
                                   lens)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    with torch.inference_mode():  # serving: the forward kernel alone
        mha_attention(q, k, v)
    assert mha_attention_bwd.launches == before[1] + 1


@pytest.mark.parametrize("b", [8, 13, 32])
def test_loss_kernel_gradient_matches_plain(cuda, b):
    gen = torch.Generator(device=cuda).manual_seed(b)
    v = torch.randn(b, 512, generator=gen, device=cuda, requires_grad=True)
    a = torch.randn(b, 512, generator=gen, device=cuda, requires_grad=True)
    before = fused_triplet_loss.launches
    got = torch.autograd.grad(fused_triplet_loss(v, a, 0.2), (v, a))
    assert fused_triplet_loss.launches == before + 1
    want = torch.autograd.grad(fused_triplet_loss_plain(v, a, 0.2), (v, a))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
