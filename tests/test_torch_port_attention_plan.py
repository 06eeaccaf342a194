"""The float32 attention forward's plan and its split-and-combine arithmetic.

`_f32_plan` chooses, from the shapes alone, how many key splits the card's
float32 forward cuts each row into; `_f32_key_splits` gives their key
ranges as the launch cuts them.  Here the plan is checked at the main
paths' shapes, and a plain PyTorch model of what the kernel does with it
(each split's partial softmax in log2 units, combined by the log-sum-exps,
as `attention_fwd_f32_kernel` and `attention_fwd_f32_combine_kernel` in
peppa_tpu_torch/csrc/attention.cu) is held against the port's plain
version and the JAX package's Pallas kernel in interpret mode (its
reference at length 0).  The kernel
itself is held against the plain version on the card by
tests/test_torch_port_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.ops.pallas.attention import (mha_attention as jax_mha,
                                            mha_attention_reference)
from peppa_tpu_torch.ops.cuda.attention import (NEG_INF, _f32_key_splits,
                                                _f32_plan,
                                                mha_attention_plain)

SMS = 132  # an H100's SMs
# (B, T) of every path that runs the float32 forward (H = 12): the float32
# Embedder (phase 7), the aligner's buckets (realign), the card-vs-CPU
# embeddings and micro-step (B = 1, 2 at 2.3 s), chip_smoke's kernel checks
# (B = 8 and 32) and T past the TPU kernel's bound
MAIN_SHAPES = [(32, 316), (1, 99), (1, 199), (1, 399), (1, 799), (1, 316),
               (2, 316), (8, 316), (32, 826), (1, 2049), (1, 3001)]


@pytest.mark.parametrize("b,t", MAIN_SHAPES)
def test_plan_covers_each_key_once(b, t):
    rows, n_splits = _f32_plan(b, 12, t)
    assert rows == 64
    key_tiles = -(-t // 64)
    assert 1 <= n_splits <= key_tiles
    ranges = _f32_key_splits(t, n_splits)
    assert len(ranges) == n_splits
    covered = [j for k0, k1 in ranges for j in range(k0, k1)]
    assert covered == list(range(t))  # each key once, in split order
    assert all(k1 > k0 for k0, k1 in ranges)  # none empty at full length
    assert all(k0 % 64 == 0 for k0, _ in ranges)  # whole 64-key tiles


def test_plan_at_the_user_shapes():
    """One split where the tiles already fill the card (the float32
    Embedder's 1920 tiles); at the aligner's longest bucket the grid
    holds at least two blocks per SM."""
    assert _f32_plan(32, 12, 316) == (64, 1)
    _, n_splits = _f32_plan(1, 12, 799)
    assert 12 * 13 * n_splits >= 2 * SMS
    for t in (199, 399):
        assert _f32_plan(1, 12, t)[1] > 1


def test_plan_reads_only_shapes():
    """Plain ints in, plain ints out: nothing of a tensor, so nothing to
    wait for on the card."""
    plan = _f32_plan(1, 12, 799)
    assert all(type(x) is int for x in plan)
    assert _f32_plan(1, 12, 799) == plan


def _split_combine(q, k, v, lengths, scale, n_splits):
    """The kernel's arithmetic in plain PyTorch: (out, natural-log lse).

    Split s takes keys [k0, k1) of `_f32_key_splits`, clipped to the row's
    valid keys (all T at length 0, where the scores run at scale 0);
    within it m = the max of the scores times scale*log2(e), l = sum 2^(x
    - m), acc = sum 2^(x - m) v, and a split with no valid key gives m =
    -inf, l = 0.  The splits combine in order: M = max m_s over l_s > 0,
    w_s = 2^(m_s - M), out = sum w_s acc_s / sum w_s l_s."""
    b, t, h, hd = q.shape
    lens = (torch.full((b,), t) if lengths is None else lengths).long()
    all_masked = lens < 1
    n_keys = torch.where(all_masked, torch.full_like(lens, t),
                         lens.clamp(max=t))
    c = torch.where(all_masked, 0.0, scale * math.log2(math.e))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    x = s * c[:, None, None, None]
    key = torch.arange(t)
    parts = []
    for k0, k1 in _f32_key_splits(t, n_splits):
        valid = ((key >= k0)[None, :] & (key < k1)[None, :]
                 & (key[None, :] < n_keys[:, None]))[:, None, None, :]
        xs = x.masked_fill(~valid, -math.inf)
        m = xs.amax(-1)
        p = torch.where(valid, torch.exp2(xs - m.clamp(min=-3e38)[..., None]),
                        torch.zeros(()))
        parts.append((m, p.sum(-1), torch.einsum("bhqk,bkhd->bhqd", p, v)))
    big = torch.stack([torch.where(l > 0, m, -math.inf) for m, l, _ in parts])
    mx = big.amax(0)
    total = torch.zeros_like(mx)
    acc = torch.zeros(b, h, t, hd)
    for m, l, a in parts:
        w = torch.where(l > 0, torch.exp2(m - mx), torch.zeros(()))
        total = total + l * w
        acc = acc + w[..., None] * a
    out = (acc / total[..., None]).permute(0, 2, 1, 3)
    lse = torch.where(all_masked[:, None, None], NEG_INF,
                      mx * math.log(2)) + torch.log(total)
    return out, lse


def _logsumexp(q, k, lengths, scale):
    t = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if lengths is not None:
        mask = torch.arange(t)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    return torch.logsumexp(logits, -1)


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("length", [149, 1, 0, 64, 65, 128, 129, None])
def test_split_combine_matches_plain(rng, n_splits, length):
    """B=1, H=3, hd=16, T=150 (three key tiles): lengths T-1, 1, 0, on
    each side of a split edge, and none; length 1 leaves the later splits
    wholly past the last valid key."""
    t = 150
    q, k, v = (torch.from_numpy(rng.normal(size=(1, t, 3, 16))
                                .astype(np.float32)) for _ in range(3))
    lengths = None if length is None else torch.tensor([length])
    scale = 16 ** -0.5
    out, lse = _split_combine(q, k, v, lengths, scale, n_splits)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    want = mha_attention_plain(q, k, v, lengths, scale)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, _logsumexp(q, k, lengths, scale),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [149, 1, 0])
def test_split_combine_matches_pallas(rng, length):
    """The same model against the JAX package, three splits: its Pallas
    kernel in interpret mode (the TPU kernel this route replaces) at
    lengths T-1 and 1; at length 0 its `mha_attention_reference`, which
    averages v over T as the port does (the Pallas kernel averages over
    its padded T, ROADMAP C.3)."""
    t = 150
    q, k, v = (rng.normal(size=(1, t, 2, 16)).astype(np.float32)
               for _ in range(3))
    lens = np.asarray([length], np.int32)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    if length:
        want = jax_mha(jq, jk, jv, lengths=jl, interpret=True)
    else:
        want = mha_attention_reference(jq, jk, jv, lengths=jl)
    out, _ = _split_combine(*map(torch.from_numpy, (q, k, v)),
                            torch.from_numpy(lens), 16 ** -0.5, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
