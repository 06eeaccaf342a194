"""Channel-normalisation statistics of the video branch.

The port's own copy of peppa_tpu/models/normalization.py: 'kinetics' stats
when the video tower is pretrained, 'peppa' (training-set) stats otherwise,
'imagenet' for the static image encoder.  A stats file under
`<data_dir>/out/` (the JAX package's `.npz`, or the reference's
torch-saved `Stats`) takes precedence over the built-in values.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PEPPA_MEAN = (0.6275, 0.6627, 0.6687)
PEPPA_STD = (0.2417, 0.2088, 0.2749)


def _load_stats_file(path: str):
    """Read a stats file: `.npz`, or the reference's torch-saved Stats."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return (tuple(z["video_mean"].tolist()),
                    tuple(z["video_std"].tolist()))
    import torch

    stats = torch.load(path, map_location="cpu", weights_only=False)
    return (tuple(np.asarray(stats.video_mean).reshape(-1).tolist()),
            tuple(np.asarray(stats.video_std).reshape(-1).tolist()))


def _from_files(data_dir: str, names, default):
    for name in names:
        path = os.path.join(data_dir, "out", name)
        if os.path.exists(path):
            try:
                return _load_stats_file(path)
            except (OSError, KeyError, ValueError, AttributeError,
                    RuntimeError):
                pass  # unreadable stats file: use the built-in values
    return default


def resolve_stats(normalization: str, data_dir: str = "data"
                  ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Return (mean, std) for 'peppa' | 'kinetics' | 'imagenet'."""
    if normalization == "imagenet":
        return IMAGENET_MEAN, IMAGENET_STD
    if normalization == "kinetics":
        return _from_files(data_dir, ("kinetics-stats.npz", "kinetics-stats.pt"),
                           (KINETICS_MEAN, KINETICS_STD))
    if normalization == "peppa":
        return _from_files(data_dir, ("stats.npz", "stats.pt"),
                           (PEPPA_MEAN, PEPPA_STD))
    raise ValueError(f"Unsupported normalization type {normalization}")
