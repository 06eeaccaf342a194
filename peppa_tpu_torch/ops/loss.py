"""Contrastive margin loss over the cross-modal similarity matrix.

Mirrors peppa_tpu/ops/loss.py.  `triplet_loss` always goes through the fused
computation (`ops/cuda/loss.py`): the CUDA kernel on the card, its plain
version on the CPU.  The JAX package's B <= 1024 cap was a VMEM limit of the
TPU kernel; the CUDA kernel takes any B, so the cap does not carry over.
`milnce_loss` comes with the training slice.
"""

from __future__ import annotations

import torch

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
