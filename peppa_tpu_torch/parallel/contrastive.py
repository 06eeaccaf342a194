"""The global-negative contrastive loss over the ranks of a data-parallel
run.

Mirrors peppa_tpu/parallel/contrastive.py, whose `shard_map` program this
spells out over `torch.distributed` (`parallel/mesh.py`): each rank
L2-normalises its rows and gathers the normalised rows of every rank
(embeddings travel, B x 512 x 4 bytes a rank and modality, never
activations), computes its (B, W * B) slab of the cosine matrix and the
global diagonal, and sums the row hinge and the column hinge off the
diagonal (reference pig/loss.py:41-48); the total over the ranks, / (W *
B)^2, equals `ops/loss.py::triplet_loss` on the gathered batch.  The full
(W * B)^2 matrix never exists on one card.

Plain PyTorch, as the JAX function is `jnp` inside `shard_map` (no Pallas
kernel): with `tpu.global_negative_loss: false` the train step takes the
fused loss kernel on the gathered rows instead (`training/step.py`).
"""

from __future__ import annotations

import torch

from peppa_tpu_torch.ops.similarity import l2_normalize
from peppa_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum


def global_negative_loss(v: torch.Tensor, a: torch.Tensor, mesh: Mesh,
                         margin: float = 0.2) -> torch.Tensor:
    """`triplet_loss` of the global batch from this rank's (B, D) video
    and audio embeddings: the same scalar on every rank.  Its backward
    gives this rank the gradient of the global loss with respect to its
    own rows (`parallel/mesh.py`'s rule)."""
    b, w, rank = v.shape[0], mesh.data, mesh.rank
    v_n = l2_normalize(v.float(), dim=1)
    a_n = l2_normalize(a.float(), dim=1)
    a_all = all_gather_rows(a_n, mesh)  # (W * B, D)
    v_all = all_gather_rows(v_n, mesh)
    m_rows = v_n @ a_all.T  # my rows of the global matrix
    diag = torch.sum(v_all * a_all, dim=1)  # the global diagonal
    my_diag = diag[rank * b:(rank + 1) * b]
    row_ids = rank * b + torch.arange(b, device=v.device)
    col_ids = torch.arange(w * b, device=v.device)
    off_diag = row_ids[:, None] != col_ids[None, :]
    c_col = torch.clamp(margin + m_rows - diag[None, :], min=0.0)
    c_row = torch.clamp(margin + m_rows - my_diag[:, None], min=0.0)
    local = torch.sum(torch.where(off_diag, c_col + c_row,
                                  torch.zeros((), device=v.device)))
    total = all_reduce_sum(local, mesh, reduce_grad=False)
    return total / ((w * b) * (w * b))
