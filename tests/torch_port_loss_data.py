"""Inputs for the triplet-loss gradient tests whose hinges are active in
some pairs and not in others.

With `randn` rows at D=512 the off-diagonal cosines are about +-0.044, so
every hinge of margin 0.2 is active and a kernel that got the inactive case
wrong would still agree with its plain version.  `mixed_activity` builds
a = v + noise, where the noise keeps part of each row of v and redraws the
rest, on a grid where every row has the same power-of-two norm and entries
of +-1: then Vn, An and every entry of M = Vn An^T are exact in float32 in
any summation order, so the kernel, cuBLAS, the CPU and the JAX package
agree on every indicator.  Continuous data cannot promise that: at B >= 64
some hinge always lies within 1e-5 of 0, where a tie is a true
discontinuity of the gradient.  Imports numpy and torch only.
"""

import numpy as np
import torch


def mixed_activity(b: int, d: int, seed: int, margin: float = 0.2):
    """(v, a) float32 numpy (b, d), b >= 3, d >= 8, made from `seed`.  Checks
    with the plain float32 formulas that the share of active hinges lies in
    (0.2, 0.8) and that no hinge lies within 1e-5 of 0."""
    if b < 3 or d < 8:
        raise ValueError(f"mixed activity needs b >= 3 and d >= 8: {b}, {d}")
    rng = np.random.default_rng(seed)
    nnz = 4 ** int(np.log(d // 4) / np.log(4) + 1e-9)  # nonzeros per row
    v = np.zeros((b, d), np.float32)
    a = np.zeros((b, d), np.float32)
    # M_ii = kept / nnz around the margin; off-diagonal M_ij spread about 0
    lo, hi = max(1, round(0.1 * nnz)), max(2, round(0.35 * nnz))
    for i in range(b):
        support = rng.choice(d, size=nnz, replace=False)
        v[i, support] = rng.choice([-1.0, 1.0], size=nnz)
        kept = int(rng.integers(lo, hi + 1))
        a[i, support[:kept]] = v[i, support[:kept]]
        fresh = rng.choice(np.setdiff1d(np.arange(d), support),
                           size=nnz - kept, replace=False)
        a[i, fresh] = rng.choice([-1.0, 1.0], size=nnz - kept)

    vt, at = torch.from_numpy(v), torch.from_numpy(a)
    vn = vt / torch.linalg.norm(vt, dim=1, keepdim=True)
    an = at / torch.linalg.norm(at, dim=1, keepdim=True)
    m = vn @ an.T
    diag = torch.diagonal(m)
    off = ~torch.eye(b, dtype=torch.bool)
    hinges = torch.cat([(margin + m - diag[None, :])[off],
                        (margin + m - diag[:, None])[off]])
    share = (hinges > 0).float().mean().item()
    gap = hinges.abs().min().item()
    assert 0.2 < share < 0.8, f"share of active hinges {share}"
    assert gap > 1e-5, f"a hinge lies within {gap} of 0"
    return v, a
