"""Request-batching primitives of the serving path.

The port's own copy of peppa_tpu/utils/request_batching.py: requests are
grouped by duration bucket, zero-padded to the bucket's shape and batched to
a fixed batch size; video is canonicalised to uint8 first.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np


def canonicalize_video(x) -> np.ndarray:
    """Clip -> uint8.  Float inputs are read as [0, 1] and quantised; uint8
    passes through.  Done before bucketing, so that a bucket mixing dtypes
    cannot truncate floats on assignment into the uint8 batch."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def group_by_bucket(items: Sequence[np.ndarray],
                    bucket_of: Callable[[np.ndarray], int]
                    ) -> Dict[int, List[int]]:
    """Item indices grouped by their bucket size, preserving arrival order."""
    by_bucket: Dict[int, List[int]] = {}
    for i, item in enumerate(items):
        by_bucket.setdefault(bucket_of(item), []).append(i)
    return by_bucket


def padded_chunk(items: Sequence[np.ndarray], chunk: Sequence[int],
                 size: int, batch_size: int, trailing_shape, dtype
                 ) -> np.ndarray:
    """One zero-padded (batch_size, size, *trailing) request batch.  Items
    longer than the bucket are cropped to it."""
    batch = np.zeros((batch_size, size) + tuple(trailing_shape), dtype)
    for row, i in enumerate(chunk):
        n = min(items[i].shape[0], size)
        batch[row, :n] = items[i][:n]
    return batch
