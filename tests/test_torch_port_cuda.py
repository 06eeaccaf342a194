"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA card and skips without one.  The file imports
nothing of JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import math

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
@pytest.mark.parametrize("t,hd", [(1, 64), (63, 64), (64, 64), (65, 64),
                                  (77, 64), (127, 64), (128, 64), (129, 64),
                                  (316, 64), (826, 64), (40, 16), (50, 32)])
def test_attention_kernel_matches_plain(cuda, dtype, tol, t, hd):
    """Full and ragged lengths (T and 1 among them) around the 64-key and
    128-row tile edges; the same inputs give the same bits again."""
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(4, t, 12, hd, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    lens = torch.tensor([t, max(t // 2, 1), min(3, t), 1], device=cuda)
    for lengths in (None, lens):
        before = mha_attention.launches
        got = mha_attention(q, k, v, lengths)
        assert mha_attention.launches == before + 1
        want = mha_attention_plain(q, k, v, lengths)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got, mha_attention(q, k, v, lengths))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_attention_kernel_length_zero(cuda, dtype, tol):
    """A row of length 0 scores every key at -1e30: its output averages v
    over T (ROADMAP C), as the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 150, 12, 64, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    lens = torch.tensor([150, 0], device=cuda)
    got = mha_attention(q, k, v, lens)
    want = mha_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    mean = v[1].float().mean(0, keepdim=True).expand(150, 12, 64)
    torch.testing.assert_close(got[1].float(), mean, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_attention_kernel_reads_strided_views(cuda, dtype, tol):
    """q/k/v as slices of one fused (B, T, 3, H, hd) projection, a
    head-major (B, H, T, hd) tensor seen as (B, T, H, hd), q/k/v whose
    head dim is not contiguous, and views whose rows are not 16-byte
    aligned (the last two take the kernel's element-wise load path)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 99, 3, 12, 64, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    heads_first = torch.randn(2, 12, 99, 64, generator=gen, device=cuda
                              ).to(dtype).transpose(1, 2)
    dim_strided = torch.randn(3, 2, 99, 64, 12, generator=gen, device=cuda
                              ).to(dtype).transpose(3, 4)
    n = 2 * 99 * 12 * 64
    flat = torch.randn(3 * n + 1, generator=gen, device=cuda).to(dtype)
    unaligned = [flat[1 + i * n:1 + (i + 1) * n].view(2, 99, 12, 64)
                 for i in range(3)]
    for args in ((q, k, v), (heads_first, k, v),
                 (q, dim_strided[0], dim_strided[1]), tuple(dim_strided),
                 (unaligned[0], k, v), tuple(unaligned)):
        got = mha_attention(*args)
        want = mha_attention_plain(*(x.contiguous() for x in args))
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [65, 316, 826])
def test_attention_kernel_lse(cuda, dtype, t):
    """The log-sum-exp the forward writes for the backward, of the masked,
    scaled float32 scores (length 0 included): natural-log units in
    float32, log2 units in bf16, held here in natural-log units."""
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(4, t, 12, 64, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    scale = 64 ** -0.5
    lens = torch.tensor([t, t // 2, 1, 0], device=cuda)
    for lengths in (None, lens):
        _, lse = _launch(q, k, v, lengths, scale, with_lse=True)
        if dtype == torch.bfloat16:
            lse = lse * math.log(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                              k.float())
        if lengths is not None:
            mask = torch.arange(t, device=cuda)[None, :] < lengths[:, None]
            logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                                   rtol=1e-5, atol=1e-5)


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


def _bwd(q, k, v, do, lengths, scale=None):
    """The backward kernel on the forward kernel's log-sum-exp and output."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out, lse = _launch(q, k, v, lengths, scale, with_lse=True)
    return mha_attention_bwd(q, k, v, do, lengths, scale, lse, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 316, 826])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_attention_bwd_kernel_matches_plain(cuda, dtype, t, hd):
    """Full and ragged lengths (1 and 0 among them) around the 16-row
    steps, 64-row stream tiles and 128-row block tiles; masked keys get
    exactly zero dK and dV; the same inputs give the same bits again."""
    gen = torch.Generator(device=cuda).manual_seed(t * hd)
    q, k, v, do = (torch.randn(4, t, 12, hd, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    lens = torch.tensor([t, max(t // 2, 1), min(3, t), 1], device=cuda)
    with_zero = torch.tensor([0, t, 1, max(t - 1, 1)], device=cuda)
    for lengths in (None, lens, with_zero):
        before = mha_attention_bwd.launches
        got = _bwd(q, k, v, do, lengths)
        assert mha_attention_bwd.launches == before + 1
        want = mha_attention_bwd_plain(q, k, v, do, lengths)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])
        if lengths is lens:  # masked keys: exactly zero dK and dV
            for g in got[1:]:
                assert not g[1, max(t // 2, 1):].any() and not g[3, 1:].any()
        again = _bwd(q, k, v, do, lengths)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_bwd_kernel_reads_strided_views(cuda, dtype):
    """q/k/v/dO as slices of one fused projection, head-major and
    dim-strided views, and views whose rows are not 16-byte aligned (these
    take the bf16 kernels' synchronous staging path)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 99, 4, 12, 64, generator=gen, device=cuda).to(dtype)
    q, k, v, do = qkv.unbind(2)
    heads_first = torch.randn(2, 12, 99, 64, generator=gen, device=cuda
                              ).to(dtype).transpose(1, 2)
    dim_strided = torch.randn(2, 2, 99, 64, 12, generator=gen, device=cuda
                              ).to(dtype).transpose(3, 4)
    n = 2 * 99 * 12 * 64
    flat = torch.randn(4 * n + 1, generator=gen, device=cuda).to(dtype)
    unaligned = [flat[1 + i * n:1 + (i + 1) * n].view(2, 99, 12, 64)
                 for i in range(4)]
    lens = torch.tensor([99, 40], device=cuda)
    for args in ((q, k, v, do), (heads_first, k, v, do),
                 (q, dim_strided[0], dim_strided[1], do),
                 (unaligned[0], k, v, do), tuple(unaligned)):
        for lengths in (None, lens):
            got = _bwd(*args, lengths)
            want = mha_attention_bwd_plain(*(x.contiguous() for x in args),
                                           lengths)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(),
                                           rtol=TOL[dtype], atol=TOL[dtype])


def test_attention_bwd_length_one_row_has_p_one(cuda):
    """The bf16 backward recomputes P = 2^(x - lse2) from the rounded scaled
    score x = s * (scale * log2 e) that the forward's softmax used.  On a
    row with one key the forward's lse2 is that x, bit for bit, so the
    exponent is 0 and P is exactly 1.  Scores of multiples of 1/16 sum
    exactly in any order, so the float32 s here is the kernel's."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randint(-3, 4, (2, 70, 12, 64), generator=gen,
                                 device=cuda).to(torch.bfloat16) / 4
                   for _ in range(4))
    lens = torch.tensor([70, 1], device=cuda)
    scale = 64 ** -0.5
    out, lse2 = _launch(q, k, v, lens, scale, with_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())[1, :, :, 0]
    scale_log2 = (torch.tensor(scale, dtype=torch.float32)
                  * torch.tensor(1.4426950408889634, dtype=torch.float32))
    assert torch.equal(lse2[1], s * scale_log2.to(cuda))
    # with P = 1: dV of the one key sums dO exactly; dS = 0
    dq, dk, dv = mha_attention_bwd(q, k, v, do, lens, scale, lse2, out)
    assert torch.equal(dv[1, 0], do[1].float().sum(0).to(torch.bfloat16))
    assert not dv[1, 1:].any() and not dk[1].any() and not dq[1].any()


def test_attention_bwd_kernel_length_zero(cuda):
    """Length 0 follows the forward (P uniform over T): dQ = dK = 0 and dV
    averages dO, as the plain version defines it."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, k, v, do = (torch.randn(2, 50, 2, 32, generator=gen, device=cuda)
                       .to(dtype) for _ in range(4))
        lens = torch.tensor([50, 0], device=cuda)
        got = _bwd(q, k, v, do, lens)
        want = mha_attention_bwd_plain(q, k, v, do, lens)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol)
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
