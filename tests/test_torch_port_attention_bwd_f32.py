"""The float32 attention backward's arithmetic, held on the CPU.

The card's float32 backward (`attention_bwd_dq_f32_kernel` and
`attention_bwd_dkdv_f32_kernel` in peppa_tpu_torch/csrc/attention.cu)
takes D = rowsum(dO o O) from the forward's float32 output instead of
rowsum(dP o P), recomputes P from the forward's natural-log log-sum-exp in
log2 units, and sums dQ over 64-key tiles and dK, dV over 64-query tiles
in order.  Here a plain PyTorch model of that arithmetic is held against
the port's plain version (`mha_attention_bwd_plain`) and the JAX package's
`_bwd_kernel` (the gradient of its Pallas `mha_attention` in interpret
mode; at length 0 the gradient of `mha_attention_reference`, since the
Pallas kernel averages over its padded T there, ROADMAP C.3), at rtol and
atol 1e-4.  The kernels themselves are held against the plain version on
the card by tests/test_torch_port_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.ops.pallas.attention import (mha_attention as jax_mha,
                                            mha_attention_reference)
from peppa_tpu_torch.ops.cuda.attention import (NEG_INF,
                                                mha_attention_bwd_plain,
                                                mha_attention_plain)

TILE = 64  # rows of a streamed tile, `kBlockK` in csrc/attention.cu
TOL = 1e-4  # the float32 backward's tolerance (chip_smoke.TOL_ATTN_BWD)
LENGTHS = [None, 0, 1, 63, 64, 65, -1]  # -1: T - 1


def _inputs(seed, b, t, h, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, hd)).astype(np.float32)
            for _ in range(4)]


def _tiled_bwd(q, k, v, do, lengths, scale):
    """(dq, dk, dv) as the float32 kernels compute them, in plain PyTorch.

    O and the natural-log lse come from the plain forward in float32;
    D = dO . O; P = 2^(s * scale*log2(e) - lse*log2(e)) on the valid keys
    (0 past them; 1/T on a row of length 0, whose dS is 0); dS = P o (dP -
    D).  dQ sums dS K over 64-key tiles in order, dK and dV sum dS^T q
    and P^T dO over 64-query tiles in order."""
    b, t, h, hd = q.shape
    out = mha_attention_plain(q, k, v, lengths, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    lens = torch.full((b,), t) if lengths is None else lengths.long()
    if lengths is not None:
        mask = torch.arange(t)[None, :] < lens[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    lse = torch.logsumexp(logits, -1)  # (b, h, t), natural log
    all_masked = (lens < 1)[:, None, None, None]
    n_keys = torch.where(lens < 1, torch.full_like(lens, t),
                         lens.clamp(max=t))
    valid = (torch.arange(t)[None, :] < n_keys[:, None])[:, None, None, :]
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    d = torch.einsum("bqhd,bqhd->bhq", do, out)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(s * c - (lse * log2e)[..., None])
    p = torch.where(valid, p, torch.zeros(()))
    p = torch.where(all_masked, torch.full((), 1.0 / t), p)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = torch.where(all_masked, torch.zeros(()), p * (dp - d[..., None]))
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for j in range(0, t, TILE):
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds[..., j:j + TILE],
                               k[:, j:j + TILE])
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p[:, :, j:j + TILE],
                               do[:, j:j + TILE])
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds[:, :, j:j + TILE],
                               q[:, j:j + TILE])
    return dq * scale, dk * scale, dv


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def _length(length, t):
    """The kernel's min(length, T); -1 stands for T - 1."""
    return None if length is None else min(t - 1 if length < 0 else length, t)


@pytest.mark.parametrize("length", LENGTHS,
                         ids=lambda x: "full" if x is None else
                         ("T-1" if x == -1 else f"len{x}"))
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("t", [50, 128, 150])  # one, two and three tiles
def test_tiled_model_matches_plain(t, hd, length):
    q, k, v, do = map(torch.from_numpy, _inputs(t + hd, 1, t, 2, hd))
    n = _length(length, t)
    lengths = None if n is None else torch.tensor([n])
    scale = hd ** -0.5
    got = _tiled_bwd(q, k, v, do, lengths, scale)
    assert all(torch.isfinite(g).all() for g in got)
    _close(got, mha_attention_bwd_plain(q, k, v, do, lengths, scale))
    if n is not None and n > 0:  # masked keys: exactly zero dK and dV
        assert not got[1][:, n:].any() and not got[2][:, n:].any()
    if n == 0:  # P uniform over T: dQ = dK = 0, dV averages dO
        assert not got[0].any() and not got[1].any()


def _jax_grads(q, k, v, do, lengths, reference=False):
    args = [jnp.asarray(x) for x in (q, k, v)]
    jl = jnp.asarray(lengths, jnp.int32)
    if reference:
        fn = lambda a, b, c: mha_attention_reference(a, b, c, lengths=jl)
    else:
        fn = lambda a, b, c: jax_mha(a, b, c, lengths=jl, interpret=True)
    _, vjp = jax.vjp(fn, *args)
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("t", [50, 150])
def test_tiled_model_matches_pallas(t, hd):
    """Six examples of one batch with lengths T, 1, 63, 64, 65 and T - 1
    (each at most T) against `_bwd_kernel` in interpret mode."""
    q, k, v, do = _inputs(7 * t + hd, 6, t, 2, hd)
    lens = np.asarray([min(n, t) for n in (t, 1, 63, 64, 65, t - 1)],
                      np.int32)
    got = _tiled_bwd(*map(torch.from_numpy, (q, k, v, do)),
                     torch.from_numpy(lens), hd ** -0.5)
    _close(got, _jax_grads(q, k, v, do, lens))


def test_tiled_model_length_zero_matches_reference():
    """Length 0 beside a full row: the gradient of the JAX package's
    reference, which averages over T as the port does."""
    t, hd = 150, 16
    q, k, v, do = _inputs(3, 2, t, 2, hd)
    lens = np.asarray([0, t], np.int32)
    got = _tiled_bwd(*map(torch.from_numpy, (q, k, v, do)),
                     torch.from_numpy(lens), hd ** -0.5)
    _close(got, _jax_grads(q, k, v, do, lens, reference=True))


def test_d_from_o_at_t826_length3():
    """T=826, hd 16, length 3: every query row attends to 3 keys, so dK
    of each sums D over 826 rows.  The bf16 kernels' D from a rounded O
    broke 2e-2 there; the float32 D = dO . O stays within 1e-4 of the plain
    version's rowsum(dP o P) and of `_bwd_kernel`."""
    t, hd = 826, 16
    q, k, v, do = _inputs(826, 1, t, 2, hd)
    lens = np.asarray([3], np.int32)
    tq = [torch.from_numpy(x) for x in (q, k, v, do)]
    got = _tiled_bwd(*tq, torch.from_numpy(lens), hd ** -0.5)
    _close(got, mha_attention_bwd_plain(*tq, torch.from_numpy(lens)))
    _close(got, _jax_grads(q, k, v, do, lens))
