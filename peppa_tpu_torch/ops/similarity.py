"""Similarity primitives: L2 normalisation, the cosine matrix and the
row-wise cosine similarity.

Mirrors peppa_tpu/ops/similarity.py.  The JAX package computes the cosine
matrix at `Precision.HIGHEST`; the port's counterpart is a full-f32 cuBLAS
product, so importing this module sets
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default, pinned
here because retrieval ranking is sensitive to similarity precision).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """`x` scaled to unit L2 norm along `dim` (norm taken in float32)."""
    norm = torch.sqrt(torch.sum(torch.square(x.float()), dim=dim,
                                keepdim=True))
    return (x / torch.clamp(norm, min=eps).to(x.dtype)).to(x.dtype)


def cosine_matrix(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(len(u), len(v)) float32 matrix of row-wise cosine similarities."""
    u_n = l2_normalize(u, dim=1).float()
    v_n = l2_normalize(v, dim=1).float()
    return u_n @ v_n.T


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = 1,
                      eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity in float32: dot / max(|a| |b|, eps), the
    two norms taken separately (as `F.cosine_similarity` and the JAX
    package do), so that equal rows give exactly equal similarities."""
    a, b = a.float(), b.float()
    dot = torch.sum(a * b, dim=dim)
    na = torch.linalg.norm(a, dim=dim)
    nb = torch.linalg.norm(b, dim=dim)
    return dot / torch.clamp(na * nb, min=eps)
