"""Similarity primitives: L2 normalisation, the cosine matrix and the
row-wise cosine similarity; and the port's float32 precision pins.

Mirrors peppa_tpu/ops/similarity.py.  The JAX package computes the cosine
matrix at `Precision.HIGHEST`; the port's counterpart is a full-f32 cuBLAS
product, so importing this module sets
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default, pinned
here because retrieval ranking is sensitive to similarity precision).

It also sets `torch.backends.cudnn.allow_tf32 = False`: PyTorch leaves it
True, which runs every float32 convolution (the wav2vec2 conv extractor and
`pos_conv`, the video trunks) in TF32, with a 10-bit mantissa.  On an H100
that put the float32 paths outside the port's tolerances against the CPU:
the aligner's CTC log-probs 1.2e-3 apart with one alignment changed, the
float32 Embedder's wav2vec stage 2.3e-3, a training step's audio gradients
at 57 times their tolerance (`chip_smoke.py` phases 8, 7 and 5; 1e-4 and
1e-3 of each gradient's largest value).  Every tower module imports this
one, so every path that builds a tower runs under both pins.  bf16
convolutions do not read the flag.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
