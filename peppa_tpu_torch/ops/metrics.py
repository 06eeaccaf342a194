"""Retrieval and triplet metrics as batched tensor work on the device.

Mirrors peppa_tpu/ops/metrics.py.  Ranking uses a stable argsort, as
`jnp.argsort` is stable, so equal distances rank by index in both packages.

The bootstrap (`resampled_recall`, `resampled_recall_at_1_to_n`) draws its
`n_samples` subsets of `size` rows as permutations from a
`torch.Generator` seeded with `seed` on the CPU, then scores every subset in
one pass on the embeddings' device: a (n_samples, size, D) gather, one
batched product, one argsort and a cumulative sum.  So the card and the CPU
score the same subsets.  The draws cannot match the JAX package's
`jax.random.permutation`; `recall_from_indices` and
`recall_curve_from_indices` score given index sets, such as the JAX
package's.
"""

from __future__ import annotations

import torch

from peppa_tpu_torch.ops.similarity import (cosine_matrix, cosine_similarity,
                                            l2_normalize)


def _ranked_correct(distances: torch.Tensor,
                    correct: torch.Tensor) -> torch.Tensor:
    """`correct` reordered along the last dim by ascending distance."""
    ranked = torch.argsort(distances, dim=-1, stable=True)
    return torch.take_along_dim(correct, ranked, dim=-1)


def _gathered_targets(candidates, references, correct):
    """(each reference row's target marks in rank order, its target
    count)."""
    hit = (correct != 0).float()
    gathered = _ranked_correct(1.0 - cosine_matrix(references, candidates),
                               hit)
    return gathered, torch.sum(hit, dim=1)


def recall_at_n(candidates: torch.Tensor, references: torch.Tensor,
                correct: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Per-row recall@n: the share of each reference row's targets among
    its n nearest candidates.  `correct[j, i]` nonzero marks candidate i as
    a target of reference j."""
    gathered, targets = _gathered_targets(candidates, references, correct)
    return torch.sum(gathered[:, :n], dim=1) / targets


def recall_at_1_to_n(candidates: torch.Tensor, references: torch.Tensor,
                     correct: torch.Tensor, N: int = 1) -> torch.Tensor:
    """The recall curve recall@0..N, shape (N + 1, rows); recall@0 is 0."""
    gathered, targets = _gathered_targets(candidates, references, correct)
    cum = torch.cumsum(gathered, dim=1) / targets[:, None]
    zero = torch.zeros_like(cum[:, :1])
    return torch.cat([zero, cum[:, :N]], dim=1).T


def triplet_accuracy(anchor: torch.Tensor, positive: torch.Tensor,
                     negative: torch.Tensor, dim: int = 1,
                     discrete: bool = True) -> torch.Tensor:
    """1 where the anchor is nearer (cosine) the positive than the negative,
    0 where farther, 0.5 on a tie (sign(0) = 0); with `discrete=False` the
    difference of the two similarities."""
    diff = (cosine_similarity(anchor, positive, dim=dim)
            - cosine_similarity(anchor, negative, dim=dim))
    if discrete:
        return (torch.sign(diff) + 1.0) / 2.0
    return diff


def _subset_identity_curve(candidates: torch.Tensor,
                           references: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """(n_samples, size, size): for each subset idx[s] and each reference
    row j of it, 1 at the rank where candidate j (its one target) lies."""
    x = l2_normalize(candidates[idx], dim=-1).float()  # (S, size, D)
    y = l2_normalize(references[idx], dim=-1).float()
    distances = 1.0 - torch.bmm(y, x.transpose(1, 2))
    size = idx.shape[1]
    eye = torch.eye(size, device=distances.device).expand_as(distances)
    return _ranked_correct(distances, eye)


def recall_from_indices(candidates: torch.Tensor, references: torch.Tensor,
                        idx: torch.Tensor, n: int = 1) -> torch.Tensor:
    """recall@n of each row of each subset `idx` (n_samples, size) of the
    pairs (candidates[i], references[i]), with candidate i the one target
    of reference i: (n_samples, size)."""
    idx = torch.as_tensor(idx, device=candidates.device).long()
    gathered = _subset_identity_curve(candidates, references, idx)
    return torch.sum(gathered[..., :n], dim=-1)


def recall_curve_from_indices(candidates: torch.Tensor,
                              references: torch.Tensor, idx: torch.Tensor,
                              N: int = 1) -> torch.Tensor:
    """The recall curves recall@0..N of each subset `idx`:
    (n_samples, N + 1, size)."""
    idx = torch.as_tensor(idx, device=candidates.device).long()
    cum = torch.cumsum(_subset_identity_curve(candidates, references, idx),
                       dim=-1)
    zero = torch.zeros_like(cum[..., :1])
    return torch.cat([zero, cum[..., :N]], dim=-1).transpose(1, 2)


def bootstrap_indices(total: int, size: int, n_samples: int,
                      seed: int) -> torch.Tensor:
    """(n_samples, size) int64: the first `size` entries of `n_samples`
    permutations of range(total), drawn on the CPU from a generator seeded
    with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(total, generator=gen)[:size]
                        for _ in range(n_samples)])


def resampled_recall(candidates: torch.Tensor, references: torch.Tensor,
                     seed: int = 0, size: int = 100, n_samples: int = 100,
                     n: int = 1) -> torch.Tensor:
    """Bootstrap recall@n over `n_samples` random subsets of `size` pairs,
    on the embeddings' device: (n_samples, size)."""
    idx = bootstrap_indices(candidates.shape[0], size, n_samples, seed)
    return recall_from_indices(candidates, references, idx, n=n)


def resampled_recall_at_1_to_n(candidates: torch.Tensor,
                               references: torch.Tensor, seed: int = 0,
                               size: int = 100, n_samples: int = 100,
                               N: int = 1) -> torch.Tensor:
    """Bootstrap recall curves: (n_samples, N + 1, size)."""
    idx = bootstrap_indices(candidates.shape[0], size, n_samples, seed)
    return recall_curve_from_indices(candidates, references, idx, N=N)
