"""The port's `milnce_loss` against the JAX package's, on the CPU.

`milnce_loss` has no kernel in either package (the JAX package computes it
in XLA); the port's is plain PyTorch.  Both get the same numpy-made inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.ops.loss import milnce_loss as jax_milnce
from peppa_tpu_torch.ops.loss import milnce_loss


@pytest.mark.parametrize("b,d,scale", [(5, 16, 1.0), (8, 512, 1.0),
                                       (13, 100, 0.1), (32, 512, 3.0)])
def test_milnce_matches_jax(b, d, scale):
    rng = np.random.default_rng(b * 1000 + d)
    v = (scale * rng.normal(size=(b, d))).astype(np.float32)
    a = (scale * rng.normal(size=(b, d))).astype(np.float32)
    want = float(jax_milnce(jnp.asarray(v), jnp.asarray(a)))
    got = milnce_loss(torch.from_numpy(v), torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_milnce_golden(rng):
    """The golden case of tests/test_ops.py::test_milnce_golden."""
    v = rng.normal(size=(5, 16)).astype(np.float32)
    a = rng.normal(size=(5, 16)).astype(np.float32)
    x = v @ a.T
    num = np.diag(x)
    both = np.concatenate([x, x.T], axis=1)
    den = np.log(np.exp(both).sum(axis=1))
    want = float(np.mean(den - num))
    got = milnce_loss(torch.from_numpy(v), torch.from_numpy(a)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
