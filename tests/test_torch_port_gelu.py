"""The port's GELU against the JAX package's (peppa_tpu/ops/gelu.py).

bf16: the polynomial path must be bit-identical over every finite bf16
value.  XLA on the CPU flushes subnormal floats to zero, so the port's side
runs with `torch.set_flush_denormal(True)` to compare like with like (on
one thread: the flag is per thread).
float32: the erf form within 1e-6.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from peppa_tpu.ops.gelu import gelu as jax_gelu
from peppa_tpu_torch.ops.gelu import gelu, gelu_poly_f32


def _all_finite_bf16() -> np.ndarray:
    x = np.arange(1 << 16, dtype=np.uint16).view(ml_dtypes.bfloat16)
    return x[np.isfinite(x.astype(np.float32))]


def test_bf16_polynomial_bit_identical():
    x = _all_finite_bf16()
    want = np.asarray(jax_gelu(jnp.asarray(x))).view(np.uint16)
    xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    supported = torch.set_flush_denormal(True)
    try:
        got = gelu(xt)
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)
    assert supported  # else the comparison would not be like for like
    assert got.dtype == torch.bfloat16
    got = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want), int((got != want).sum())


def test_f32_is_erf_form():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax_gelu(jnp.asarray(x)))
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_exact_gelu_override(monkeypatch):
    x = torch.linspace(-4, 4, 257).to(torch.bfloat16)
    monkeypatch.delenv("PEPPA_EXACT_GELU", raising=False)
    assert torch.equal(gelu(x), gelu_poly_f32(x.float()).to(torch.bfloat16))
    monkeypatch.setenv("PEPPA_EXACT_GELU", "1")
    assert torch.equal(gelu(x), torch.nn.functional.gelu(x))
