"""Serving's inputs, as a bucketed service presents them to the towers.

A clip of duration d goes to the smallest bucket duration b >= d (the last
bucket when none is), its audio zero-padded or cropped to round(b * rate)
samples and its video to round(b * fps) frames.  The towers see no valid
length: the padding is part of the input, as the service's batches carry
none.  Each row of a tower is independent in eval mode, so the reference
embeds the rows in blocks of any size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bucket_length(n: int, buckets: Sequence[float], per_second: float
                  ) -> int:
    for b in buckets:
        if n <= int(round(b * per_second)):
            return int(round(b * per_second))
    return int(round(buckets[-1] * per_second))


def padded(x: np.ndarray, size: int) -> np.ndarray:
    """`x` cropped or zero-padded along its first axis to `size`."""
    out = np.zeros((size,) + x.shape[1:], x.dtype)
    n = min(size, x.shape[0])
    out[:n] = x[:n]
    return out


def as_uint8(x: np.ndarray) -> np.ndarray:
    """A float [0, 1] clip rounded to uint8; uint8 as it is."""
    if x.dtype == np.uint8:
        return x
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
