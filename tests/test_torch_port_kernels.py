"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the Pallas kernels in interpret mode (and the Pallas reference)
at the tolerances of tests/test_pallas_kernels.py.  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.ops.pallas.attention import (mha_attention as jax_mha,
                                            mha_attention_reference)
from peppa_tpu.ops.pallas.loss import fused_triplet_loss as jax_fused_loss
from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                mha_attention_plain)
from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss
from peppa_tpu_torch.ops.loss import contrastive, triplet_loss
from peppa_tpu_torch.ops.similarity import cosine_matrix


def _qkv(rng, shape, dtype=np.float32):
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("t,lengths", [(64, None), (120, (120, 80, 33, 1))])
def test_attention_matches_pallas(rng, t, lengths):
    q, k, v = _qkv(rng, (4, t, 3, 32))
    lens = np.asarray(lengths, np.int32) if lengths else None
    want = np.asarray(jax_mha(*map(jnp.asarray, (q, k, v)),
                              lengths=None if lens is None
                              else jnp.asarray(lens), interpret=True))
    got = mha_attention(*map(torch.from_numpy, (q, k, v)),
                        lengths=None if lens is None
                        else torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_bf16_matches_pallas(rng):
    q, k, v = _qkv(rng, (2, 40, 2, 16))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_mha(jq, jk, jv, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = mha_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_attention_model_shape_matches_reference(rng):
    """wav2vec2-base heads (12 x 64) at the 2.3 s bucket's T=316."""
    q, k, v = _qkv(rng, (2, 316, 12, 64))
    lens = np.asarray([316, 201], np.int32)
    want = np.asarray(mha_attention_reference(
        *map(jnp.asarray, (q, k, v)), lengths=jnp.asarray(lens)))
    got = mha_attention(*map(torch.from_numpy, (q, k, v)),
                        lengths=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_reads_strided_views(rng):
    """q/k/v as slices of one fused (B, T, 3, H, hd) projection."""
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3, 4, 16))
                           .astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = mha_attention(q, k, v)
    want = mha_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,d", [(8, 512), (13, 100), (32, 512)])
def test_loss_matches_pallas(rng, b, d):
    v = rng.normal(size=(b, d)).astype(np.float32)
    a = rng.normal(size=(b, d)).astype(np.float32)
    want = float(jax_fused_loss(jnp.asarray(v), jnp.asarray(a), 0.2, True))
    got = float(fused_triplet_loss(torch.from_numpy(v), torch.from_numpy(a),
                                   0.2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the dispatching entry point and the unfused chain agree too
    tv, ta = torch.from_numpy(v), torch.from_numpy(a)
    np.testing.assert_allclose(float(triplet_loss(tv, ta)), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(contrastive(cosine_matrix(tv, ta))),
                               want, rtol=1e-5, atol=1e-6)


def test_cpu_calls_do_not_count_as_launches(rng):
    before = (mha_attention.launches, fused_triplet_loss.launches)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (1, 8, 2, 16)))
    mha_attention(q, k, v)
    fused_triplet_loss(torch.randn(4, 8), torch.randn(4, 8))
    assert (mha_attention.launches, fused_triplet_loss.launches) == before
