"""Exact (erf) GELU with the JAX package's bf16 polynomial.

Mirrors peppa_tpu/ops/gelu.py: bf16 inputs take a degree-7-in-x^2
polynomial for Phi evaluated in float32 and rounded to bf16 (no
transcendentals; at bf16 precision it is the erf GELU on 99.5% of the bf16
domain); float32 inputs take the erf form.  `F.gelu` in bf16 rounds at other
places and is a different function, so bf16 parity needs this polynomial.
Set PEPPA_EXACT_GELU=1 to force the erf form everywhere.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

# (Phi(x) - 0.5)/x as a polynomial in u = x^2, fitted on |x| <= 4.5
# (the JAX package's scripts/fit_gelu_poly.py)
_PHI_COEFFS = (
    3.9813697629e-01,
    -6.5037173229e-02,
    9.0505252190e-03,
    -8.9168849013e-04,
    5.9422497875e-05,
    -2.5208075924e-06,
    6.0943221476e-08,
    -6.3568715724e-10,
)
_U_MAX = 20.25  # 4.5^2


def gelu_poly_f32(xf: torch.Tensor) -> torch.Tensor:
    """The polynomial GELU evaluated in float32 (input must be float32)."""
    u = torch.clamp(xf * xf, max=_U_MAX)
    p = torch.full_like(xf, _PHI_COEFFS[-1])
    for c in _PHI_COEFFS[-2::-1]:
        p = p * u + c
    phi = torch.clamp(0.5 + xf * p, 0.0, 1.0)
    return xf * phi


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU; bf16 inputs take the bf16-exact polynomial path."""
    if x.dtype == torch.bfloat16 and not os.environ.get("PEPPA_EXACT_GELU"):
        return gelu_poly_f32(x.float()).to(torch.bfloat16)
    return F.gelu(x, approximate="none")
