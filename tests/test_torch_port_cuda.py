"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA card and skips without one.  The file imports
nothing of JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import math

import pytest
import torch

from peppa_tpu_torch.ops.cuda.attention import (_f32_key_splits, _f32_plan,
                                                _launch, mha_attention,
                                                mha_attention_bwd,
                                                mha_attention_bwd_plain,
                                                mha_attention_plain)
from peppa_tpu_torch.ops.cuda import loss as loss_module
from peppa_tpu_torch.ops.cuda.loss import (fused_triplet_loss,
                                           fused_triplet_loss_and_grad_plain,
                                           fused_triplet_loss_plain)
from torch_port_loss_data import mixed_activity

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


def _loss_inputs(cuda, kind, b, d):
    if kind == "mixed":
        return (torch.from_numpy(x).to(cuda)
                for x in mixed_activity(b, d, seed=b + d))
    gen = torch.Generator(device=cuda).manual_seed(1000 * b + d)
    return (torch.randn(b, d, generator=gen, device=cuda) for _ in range(2))


@pytest.mark.parametrize(
    "kind,b,d", [(kind, b, d) for kind in ("random", "mixed")
                 for b in (1, 2, 8, 13, 32, 33, 64, 65, 1024)
                 for d in (512, 100) if kind == "random" or b >= 8])
def test_loss_kernel_with_gradient_matches_plain(cuda, kind, b, d):
    """The launch with the gradient and the one without, against the plain
    loss and closed form (loss rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
    atol 1e-6); one launch per call up to B = 64."""
    v, a = _loss_inputs(cuda, kind, b, d)
    before = fused_triplet_loss.launches
    loss, d_v, d_a = loss_module._launch(v, a, 0.2, grad=True)
    alone = loss_module._launch(v, a, 0.2, grad=False)[0]
    if b <= 64:
        assert fused_triplet_loss.launches == before + 2
    want = fused_triplet_loss_and_grad_plain(v, a, 0.2)
    torch.testing.assert_close(loss, want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(alone, loss)
    for g, w in zip((d_v, d_a), want[1:]):
        assert g.shape == (b, d) and g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("b", [32, 777])
def test_loss_kernel_gradient_is_deterministic(cuda, b):
    v, a = _loss_inputs(cuda, "random", b, 100)
    first = loss_module._launch(v, a, 0.2, grad=True)
    for _ in range(3):
        again = loss_module._launch(v, a, 0.2, grad=True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_loss_kernel_gradient_paths(cuda, monkeypatch):
    """Eval (no grad, `inference_mode`) launches without the gradient;
    training launches with it and runs no plain closed form."""
    grads = []
    launch = loss_module._launch

    def spy(v, a, margin, grad):
        grads.append(grad)
        return launch(v, a, margin, grad)

    def refuse(*args):
        raise AssertionError("plain closed form on the card")

    v, a = (x.requires_grad_() for x in _loss_inputs(cuda, "mixed", 8, 512))
    _, d_v, d_a = fused_triplet_loss_and_grad_plain(v.detach(), a.detach())
    monkeypatch.setattr(loss_module, "_launch", spy)
    monkeypatch.setattr(loss_module, "triplet_loss_bwd", refuse)
    with torch.inference_mode():
        fused_triplet_loss(v, a)
    with torch.no_grad():
        fused_triplet_loss(v, a)
    assert grads == [False, False]
    got = torch.autograd.grad(3.0 * fused_triplet_loss(v, a), (v, a))
    assert grads == [False, False, True]
    torch.testing.assert_close(got[0], 3.0 * d_v, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got[1], 3.0 * d_a, rtol=1e-4, atol=1e-6)


def test_metrics_on_the_card_equal_the_cpu(cuda):
    """The bootstrap and the triplet rounds score the same subsets on the
    card as on the CPU: the same recalls and accuracies."""
    from peppa_tpu_torch.evaluation.triplet import score_triplets
    from peppa_tpu_torch.ops.metrics import bootstrap_indices, \
        recall_from_indices, resampled_recall

    gen = torch.Generator().manual_seed(0)
    c = torch.randn(150, 512, generator=gen)
    r = c + 1.5 * torch.randn(150, 512, generator=gen)
    idx = bootstrap_indices(150, 100, 500, seed=0)
    want = recall_from_indices(c, r, idx, n=10)
    got = recall_from_indices(c.to(cuda), r.to(cuda), idx.to(cuda), n=10)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert torch.equal(resampled_recall(c.to(cuda), r.to(cuda), seed=0,
                                        n=10, n_samples=500).cpu(), want)
    duration = torch.randint(1, 4, (150,), generator=gen).float().numpy()
    on_cpu = score_triplets(c, r, duration, n_samples=500, seed=0)
    on_card = score_triplets(c.to(cuda), r.to(cuda), duration,
                             n_samples=500, seed=0)
    assert (on_card["accuracy"] == on_cpu["accuracy"]).all()
    assert (on_card["duration"] == on_cpu["duration"]).all()


def test_validation_on_the_card_runs_the_kernels_only(cuda, monkeypatch):
    """run_validation's eval steps launch the attention forward kernel (one
    per layer per batch) and the loss kernel (one per batch), and no plain
    version runs on a CUDA tensor."""
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.datamodule import SyntheticPigData
    from peppa_tpu_torch.evaluation.validation import run_validation
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.cuda import attention as attention_module

    for module, name in ((attention_module, "mha_attention_plain"),
                         (attention_module, "mha_attention_bwd_plain"),
                         (loss_module, "fused_triplet_loss_plain"),
                         (loss_module, "triplet_loss_bwd"),
                         (loss_module, "fused_triplet_loss_and_grad_plain")):
        def refuse(*args, _name=name, _real=getattr(module, name), **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{_name} ran on the card")
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, refuse)
    cfg = Config.from_dict({
        "data": {"target_size": [64, 48], "audio_sample_rate": 16000,
                 "val": {"batch_size": 8}},
        "audio": {"num_layers": 2}})
    data = SyntheticPigData(cfg, n_train=8, n_val=20)
    data.setup()
    model = init_model(cfg, seed=0)
    batches = sum(len(list(loader)) for loader in data.val_loaders())
    mha_attention.launches = fused_triplet_loss.launches = 0
    metrics = run_validation(model, data.val_loaders(), n_samples=50)
    assert set(metrics) == {"val_loss", "val_rec_fixed", "valnarr_loss",
                            "valnarr_rec_fixed", "val_triplet",
                            "valnarr_triplet"}
    assert all(math.isfinite(v) for v in metrics.values())
    assert mha_attention.launches == 2 * batches
    assert fused_triplet_loss.launches == batches


# --------------------------------------------- the data pipeline on the card
def _pack_batches(tmp_path, n_items=24, seconds=0.8):
    """A pack of `n_items` clips (24x32 frames, 800 Hz) and a plan of
    batches of 4 padded to `seconds`."""
    import numpy as np

    from peppa_tpu_torch.data.cache import write_pack
    from peppa_tpu_torch.data.types import Clip

    rng = np.random.default_rng(0)
    clips = [Clip(video=rng.integers(0, 256, size=(int(rng.integers(3, 9)),
                                                   24, 32, 3), dtype=np.uint8),
                  audio=rng.normal(size=(int(rng.integers(200, 640)),))
                  .astype(np.float32),
                  video_duration=0.5, audio_duration=0.5)
             for _ in range(n_items)]
    path = str(tmp_path / "items.pack")
    write_pack(path, clips)
    pad = (int(round(seconds * 10)), 24, 32, 3, int(round(seconds * 800)))
    plan = [(list(range(i, i + 4)), pad) for i in range(0, n_items, 4)]
    return path, plan


def test_native_batches_are_pinned(cuda, tmp_path):
    from peppa_tpu_torch.native.loader import NativeBatchLoader, NativePack

    path, plan = _pack_batches(tmp_path)
    pack = NativePack(path)
    batches = list(NativeBatchLoader(pack, plan, n_threads=2, depth=2))
    assert len(batches) == len(plan)
    for b in batches:
        for name in ("video", "audio", "video_duration", "audio_duration",
                     "video_frames", "audio_samples"):
            t = getattr(b, name)
            assert t.device.type == "cpu" and t.is_pinned(), name


def _checksum(batch):
    return [getattr(batch, f).double().sum().item()
            for f in ("video", "audio", "video_duration", "audio_duration",
                      "video_frames", "audio_samples")]


def test_side_stream_prefetcher_equals_clipbatch_to(cuda, tmp_path):
    """Several hundred batches, numpy (pinned by the worker) and native
    (pinned already), through the side-stream copies, while the consumer
    queues long work on its own stream between them: every batch reads on
    the consumer's stream as `ClipBatch.to` gives it."""
    import numpy as np

    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.native.loader import NativeBatchLoader, NativePack
    from peppa_tpu_torch.utils.prefetch import Prefetcher

    rng = np.random.default_rng(1)
    host = [ClipBatch(
        video=rng.integers(0, 256, size=(4, 8, 24, 32, 3), dtype=np.uint8),
        audio=rng.normal(size=(4, 640)).astype(np.float32),
        video_duration=rng.uniform(size=4).astype(np.float32),
        audio_duration=rng.uniform(size=4).astype(np.float32),
        video_frames=rng.integers(1, 9, size=4).astype(np.int32),
        audio_samples=rng.integers(1, 641, size=4).astype(np.int32))
        for _ in range(150)]
    path, plan = _pack_batches(tmp_path, n_items=48)
    native = list(NativeBatchLoader(NativePack(path), plan * 25, n_threads=4,
                                    depth=4))
    assert all(b.video.is_pinned() for b in native)
    for batches in (host, native):
        want = [_checksum(b.to(cuda)) for b in batches]
        before = Prefetcher.side_stream_copies
        prefetcher = Prefetcher(iter(batches), cuda, depth=3)
        busy = torch.randn(2048, 2048, device=cuda)
        got = []
        for b in prefetcher:
            for _ in range(4):  # the consumer's stream stays busy
                busy = torch.tanh(busy @ busy * 1e-3)
            sums = torch.stack([getattr(b, f).double().sum() for f in (
                "video", "audio", "video_duration", "audio_duration",
                "video_frames", "audio_samples")])
            got.append(sums)
            assert b.video.device.type == "cuda"
        prefetcher.close()
        got = [g.tolist() for g in got]
        assert got == want
        assert Prefetcher.side_stream_copies - before == len(batches)


def test_native_path_makes_no_pageable_copy(cuda, tmp_path, monkeypatch):
    """The native loader's pinned batches go to the card with no pinning
    copy in the prefetcher; numpy batches are pinned there."""
    from dataclasses import fields

    import numpy as np

    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.native.loader import NativeBatchLoader, NativePack
    from peppa_tpu_torch.utils.prefetch import Prefetcher

    pins = []
    real = torch.Tensor.pin_memory

    def counting(self, *args, **kw):
        pins.append(tuple(self.shape))
        return real(self, *args, **kw)

    path, plan = _pack_batches(tmp_path)
    loader = NativeBatchLoader(NativePack(path), plan, n_threads=2, depth=2)
    monkeypatch.setattr(torch.Tensor, "pin_memory", counting)
    moved = list(Prefetcher(iter(loader), cuda, depth=2))
    assert len(moved) == len(plan) and pins == []
    numpy_batch = ClipBatch(**{f.name: getattr(moved[0], f.name).cpu().numpy()
                               for f in fields(ClipBatch)})
    list(Prefetcher(iter([numpy_batch]), cuda, depth=0))
    assert len(pins) == 6 and np.prod(pins[0]) > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [2049, 2300, 3001])
def test_attention_kernel_past_the_tpu_bound(cuda, dtype, tol, t):
    """Past T = 2048, where the JAX package leaves its TPU kernel for its
    XLA route (`MAX_T_PAD`, VMEM), the card's kernel still runs and holds
    against its plain version: the port keeps no switch on T (ROADMAP C)."""
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(2, t, 12, 64, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    lens = torch.tensor([t, t // 3], device=cuda)
    for lengths in (None, lens):
        before = mha_attention.launches
        got = mha_attention(q, k, v, lengths)
        assert mha_attention.launches == before + 1
        want = mha_attention_plain(q, k, v, lengths)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_use_pallas_false_launches_no_attention_kernel(cuda):
    """Under `tpu.use_pallas: false` the audio tower on the card takes the
    plain route: kernel 1's counter stays at 0; with the flag on it counts
    one launch per layer."""
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.models.dual_encoder import init_model

    x = torch.randn(2, 16000, generator=torch.Generator().manual_seed(0))
    out = {}
    for flag in (False, True):
        cfg = Config.from_dict({"audio": {"num_layers": 2},
                                "training": {"trainer_args":
                                             {"precision": 32}},
                                "tpu": {"use_pallas": flag}})
        model = init_model(cfg, seed=0, device=cuda)
        before = mha_attention.launches
        with torch.inference_mode():
            out[flag] = model.encode_audio(x.to(cuda))
        assert mha_attention.launches - before == (2 if flag else 0)
    torch.testing.assert_close(out[False], out[True], rtol=1e-4, atol=1e-4)


def test_launch_count_is_exact_under_threads(cuda):
    """The aligner's pool launches kernel 1 from worker threads: the
    counter takes every launch (8 threads x 50, float32, with lengths)."""
    from concurrent.futures import ThreadPoolExecutor

    q, k, v = (torch.randn(1, 99, 12, 64, device=cuda) for _ in range(3))
    lengths = torch.tensor([98], device=cuda)

    def run(_):
        for _ in range(50):
            mha_attention(q, k, v, lengths)

    before = mha_attention.launches
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(run, range(8)))
    torch.cuda.synchronize()
    assert mha_attention.launches == before + 400


def test_ctc_logits_fn_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small wav2vec2 CTC model (2 layers, 4 heads of 16) on the card and
    on the CPU: log-probs within 1e-4 (TF32 off), one kernel 1 launch per
    layer and utterance, each with the utterance's frames as key length."""
    import numpy as np

    from peppa_tpu_torch.models import wav2vec2 as W
    from peppa_tpu_torch.models.convert import export_jax_variables
    from peppa_tpu_torch.models.dual_encoder import _init_parameters
    from peppa_tpu_torch.preprocess import forced_align as F

    cfg = W.Wav2Vec2Config(embed_dim=64, num_layers=2, num_heads=4,
                           ffn_dim=128, pos_conv_kernel=16,
                           pos_conv_groups=4, layer_drop=0.0)
    model = W.Wav2Vec2(cfg)
    _init_parameters(model, torch.Generator().manual_seed(0))
    variables = export_jax_variables(model)
    path = str(tmp_path / "a.wav")
    F._write_wav(path, np.sin(np.arange(int(1.3 * 16000)) * 0.05) * 0.3,
                 16000)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            fn = F.make_ctc_logits_fn(variables=variables, cfg=cfg,
                                      device=device)
            before = mha_attention.launches
            out[device] = fn(path)
            out[device + "_launches"] = mha_attention.launches - before
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert out["cuda_launches"] == cfg.num_layers
    assert out["cpu_launches"] == 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


# ---------------------------------------------- kernel 1, float32 route
#
# The float32 forward cuts the keys of small grids into splits combined by
# their log-sum-exps (`_f32_plan`): B=1 is the aligner's case.

ALIGN_T = (99, 199, 399, 799)  # the 2, 4, 8 and 16 s buckets


def _f32_inputs(cuda, b, t, hd=64):
    gen = torch.Generator(device=cuda).manual_seed(t)
    return [torch.randn(b, t, 12, hd, generator=gen, device=cuda)
            for _ in range(3)]


def _held(q, k, v, lengths):
    """One launch of the kernel, within 1e-5 of the plain version."""
    before = mha_attention.launches
    got = mha_attention(q, k, v, lengths)
    assert mha_attention.launches == before + 1
    want = mha_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("t", ALIGN_T)
def test_attention_f32_aligner_shapes(cuda, t):
    """B=1, H=12, hd=64 at the aligner's T with lengths T - 1, 1 and T
    (and none): the key splits and their combine, within 1e-5."""
    assert _f32_plan(1, 12, t)[1] > 1
    q, k, v = _f32_inputs(cuda, 1, t)
    _held(q, k, v, None)
    for n in (t - 1, 1, t):
        _held(q, k, v, torch.tensor([n], device=cuda))


def test_attention_f32_batch_ragged(cuda):
    """B=32, T=316 (the float32 Embedder): one split, ragged lengths."""
    assert _f32_plan(32, 12, 316)[1] == 1
    q, k, v = _f32_inputs(cuda, 32, 316)
    gen = torch.Generator(device=cuda).manual_seed(5)
    lens = torch.randint(1, 317, (32,), generator=gen, device=cuda)
    lens[:4] = torch.tensor([316, 1, 64, 65])
    _held(q, k, v, lens)
    _held(q, k, v, None)


@pytest.mark.parametrize("t", [63, 64, 65, 127, 128, 129, 191, 192, 193,
                               767, 768, 769])
def test_attention_f32_split_and_tile_edges(cuda, t):
    """T one either side of a 64-row query tile, and lengths one either
    side of each key split the plan gives at B=1 (a split wholly past
    the length adds nothing)."""
    q, k, v = _f32_inputs(cuda, 1, t)
    n_splits = _f32_plan(1, 12, t)[1]
    edges = {e for k0, k1 in _f32_key_splits(t, n_splits) for e in (k0, k1)}
    lengths = sorted({min(max(e + d, 1), t) for e in edges
                      for d in (-1, 0, 1)})
    for n in lengths:
        _held(q, k, v, torch.tensor([n], device=cuda))


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("b,t", [(1, 399), (4, 316)])
def test_attention_f32_small_head_dims(cuda, hd, b, t):
    q, k, v = _f32_inputs(cuda, b, t, hd)
    lens = torch.tensor([t - 1, 1, t, t // 2][:b], device=cuda)
    _held(q, k, v, lens)
    _held(q, k, v, None)


@pytest.mark.parametrize("t", [199, 799])
def test_attention_f32_length_zero_splits(cuda, t):
    """Length 0 at B=1 (every split runs, with scale 0): v averaged over
    T, as the plain version's."""
    q, k, v = _f32_inputs(cuda, 1, t)
    got = _held(q, k, v, torch.tensor([0], device=cuda))
    mean = v[0].mean(0, keepdim=True).expand(t, 12, 64)
    torch.testing.assert_close(got[0], mean, rtol=1e-5, atol=1e-5)


def test_attention_f32_split_views(cuda):
    """At B=1, T=799 (four splits): q/k/v as slices of one fused
    projection, a head-major tensor, a non-contiguous head dim and views
    whose rows are not 16-byte aligned (the element-wise paths)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    t = 799
    qkv = torch.randn(1, t, 3, 12, 64, generator=gen, device=cuda)
    q, k, v = qkv.unbind(2)
    heads_first = torch.randn(1, 12, t, 64, generator=gen,
                              device=cuda).transpose(1, 2)
    dim_strided = torch.randn(3, 1, t, 64, 12, generator=gen,
                              device=cuda).transpose(3, 4)
    n = t * 12 * 64
    flat = torch.randn(3 * n + 1, generator=gen, device=cuda)
    unaligned = [flat[1 + i * n:1 + (i + 1) * n].view(1, t, 12, 64)
                 for i in range(3)]
    lens = torch.tensor([t - 1], device=cuda)
    for args in ((q, k, v), (heads_first, k, v), tuple(dim_strided),
                 tuple(unaligned)):
        got = mha_attention(*args, lens)
        want = mha_attention_plain(*(x.contiguous() for x in args), lens)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t", [(1, 99), (1, 399), (1, 799), (32, 316)])
def test_attention_f32_lse_feeds_the_backward(cuda, b, t):
    """The log-sum-exp in natural-log units within 1e-5 (written by the
    combine kernel where the keys are split), and the float32 backward
    fed by it and the output within 1e-4 of its plain version."""
    q, k, v = _f32_inputs(cuda, b, t)
    do = torch.randn_like(q)
    scale = 64 ** -0.5
    lens = torch.full((b,), t - 1, device=cuda)
    lens[-1] = 1 if b > 1 else t - 1
    for lengths in (None, lens):
        out, lse = _launch(q, k, v, lengths, scale, with_lse=True)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
        if lengths is not None:
            mask = torch.arange(t, device=cuda)[None, :] < lengths[:, None]
            logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                                   rtol=1e-5, atol=1e-5)
        got = mha_attention_bwd(q, k, v, do, lengths, scale, lse, out)
        want = mha_attention_bwd_plain(q, k, v, do, lengths, scale)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t", [(1, 799), (32, 316)])
def test_attention_f32_bit_identical(cuda, b, t):
    """Repeats give the same bits, and 8 threads launching the same inputs
    each on its own stream write the bytes of one serial launch."""
    from concurrent.futures import ThreadPoolExecutor

    q, k, v = _f32_inputs(cuda, b, t)
    lens = torch.full((b,), t - 1, device=cuda)
    first = mha_attention(q, k, v, lens)
    for _ in range(3):
        assert torch.equal(first, mha_attention(q, k, v, lens))
    torch.cuda.synchronize()

    def run(_):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            outs = [mha_attention(q, k, v, lens) for _ in range(4)]
        stream.synchronize()
        return outs

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(run, range(8)))
    assert all(torch.equal(first, o) for outs in results for o in outs)


# Kernel 2's float32 route: 64-row tiles of 128 threads in two grids (query
# tiles for dQ and D = dO . O, key tiles for dK and dV), swizzled
# `cp.async` stages, and a synchronous staging path for views whose rows
# are not 16-byte vectors.


def _bwd_f32_inputs(cuda, b, t, seed, hd=64):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, t, 12, hd, generator=gen, device=cuda)
            for _ in range(4)]


def _bwd_held(q, k, v, do, lengths):
    """One launch of the float32 backward, within 1e-4 + 1e-4|plain| of
    the plain version; masked keys get exactly zero dK and dV."""
    before = mha_attention_bwd.launches
    got = _bwd(q, k, v, do, lengths)
    assert mha_attention_bwd.launches == before + 1
    want = mha_attention_bwd_plain(q, k, v, do, lengths)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    if lengths is not None:
        for i, n in enumerate(lengths.tolist()):
            if n > 0:
                assert not got[1][i, n:].any() and not got[2][i, n:].any()
    return got


@pytest.mark.parametrize("t", [2049, 3001])
def test_attention_bwd_f32_past_the_tpu_bound(cuda, t):
    """Past T = 2048 the float32 backward runs with no switch on T (ROADMAP
    C), full and ragged."""
    q, k, v, do = _bwd_f32_inputs(cuda, 2, t, t)
    for lengths in (None, torch.tensor([t, t // 3], device=cuda)):
        _bwd_held(q, k, v, do, lengths)


@pytest.mark.parametrize("b,t", [(1, 99), (1, 316), (1, 799), (2, 316),
                                 (2, 826)])
def test_attention_bwd_f32_small_grids(cuda, b, t):
    """B=1 and B=2 grids (phase 5's micro-step is B=2, T=316: 120 blocks
    a kernel), full, one key short of T, length 1 and 0."""
    q, k, v, do = _bwd_f32_inputs(cuda, b, t, 31 * t + b)
    _bwd_held(q, k, v, do, None)
    for n in (t - 1, 1, 0):
        lengths = torch.full((b,), n, device=cuda)
        lengths[0] = t - 1 if b > 1 else n
        _bwd_held(q, k, v, do, lengths)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_attention_bwd_f32_unaligned_rows_stage_synchronously(cuda, hd):
    """Views whose rows are not 16-byte vectors (one float off) take the
    synchronous staging and element-wise writes: within 1e-4 of the plain
    version and bit-identical to the `cp.async` path on contiguous copies
    (the same layout and the same order of every sum)."""
    t = 201
    gen = torch.Generator(device=cuda).manual_seed(hd)
    n = 2 * t * 12 * hd
    flat = torch.randn(4 * n + 1, generator=gen, device=cuda)
    unaligned = [flat[1 + i * n:1 + (i + 1) * n].view(2, t, 12, hd)
                 for i in range(4)]
    contiguous = [x.clone() for x in unaligned]
    scale = hd ** -0.5
    for lengths in (None, torch.tensor([t, 70], device=cuda)):
        _bwd_held(*unaligned, lengths)
        out, lse = _launch(*contiguous[:3], lengths, scale, with_lse=True)
        want = mha_attention_bwd(*contiguous, lengths, scale, lse, out)
        for args in (unaligned, [unaligned[0], *contiguous[1:]]):
            got = mha_attention_bwd(*args, lengths, scale, lse, out)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("b,t", [(8, 316), (2, 826)])
def test_attention_bwd_f32_bit_identical_threads(cuda, b, t):
    """No atomics: repeats give the same bits, and 8 threads launching the
    same inputs each on its own stream write the bytes of one serial
    launch."""
    from concurrent.futures import ThreadPoolExecutor

    q, k, v, do = _bwd_f32_inputs(cuda, b, t, 7)
    lens = torch.full((b,), t - 1, device=cuda)
    scale = 64 ** -0.5
    out, lse = _launch(q, k, v, lens, scale, with_lse=True)
    first = mha_attention_bwd(q, k, v, do, lens, scale, lse, out)
    for _ in range(2):
        again = mha_attention_bwd(q, k, v, do, lens, scale, lse, out)
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()

    def run(_):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs = [mha_attention_bwd(q, k, v, do, lens, scale, lse, out)
                    for _ in range(3)]
        stream.synchronize()
        return outs

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(run, range(8)))
    assert all(torch.equal(x, y) for outs in results for got in outs
               for x, y in zip(first, got))
