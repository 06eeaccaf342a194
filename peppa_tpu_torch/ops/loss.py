"""Contrastive margin loss over the cross-modal similarity matrix.

Mirrors peppa_tpu/ops/loss.py.  `triplet_loss` always goes through the fused
computation (`ops/cuda/loss.py`): the CUDA kernel on the card, its plain
version on the CPU.  The JAX package's B <= 1024 cap was a VMEM limit of the
TPU kernel; the CUDA kernel takes any B, so the cap does not carry over.
`milnce_loss` is plain PyTorch, as the JAX package computes it in XLA: no
kernel of its own.
"""

from __future__ import annotations

import torch

from peppa_tpu_torch.ops import similarity  # noqa: F401  full-f32 products
from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss


def contrastive(m: torch.Tensor, margin: float = 0.2) -> torch.Tensor:
    """Contrastive margin loss over a similarity matrix `m`:

        C_c[i, j] = max(0, margin + M[i, j] - M[j, j])   (column-wise hinge)
        C_r[i, j] = max(0, margin + M[i, j] - M[i, i])   (row-wise hinge)
        loss = (sum(C_c + C_r) - trace(C_c + C_r)) / B**2
    """
    m = m.float()
    diag = torch.diagonal(m)
    c = (torch.clamp(margin + m - diag[None, :], min=0.0)
         + torch.clamp(margin + m - diag[:, None], min=0.0))
    b = m.shape[0]
    return (torch.sum(c) - torch.sum(torch.diagonal(c))) / (b * b)


def triplet_loss(v: torch.Tensor, a: torch.Tensor,
                 margin: float = 0.2) -> torch.Tensor:
    """Triplet margin loss between video embeddings `v` and audio `a`:
    contrastive(cosine_matrix(v, a), margin), fused."""
    return fused_triplet_loss(v, a, margin)


def milnce_loss(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """MIL-NCE loss with one candidate per clip (reference pig/loss.py:5-26,
    peppa_tpu/ops/loss.py:84-99): X = V A^T as a full float32 product (no
    TF32: `ops/similarity.py` pins it off), then the mean over rows i of
    logsumexp_k [X, X^T][i, k] - X[i, i]."""
    x = v.float() @ a.float().T
    both = torch.cat([x, x.T], dim=1)
    peak = torch.amax(both, dim=1)
    denominator = peak + torch.log(
        torch.sum(torch.exp(both - peak[:, None]), dim=1))
    return torch.mean(denominator - torch.diagonal(x))
