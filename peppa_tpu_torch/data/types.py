"""Batch containers of the port (tensors, no pytree registration).

Layouts follow the JAX package (peppa_tpu/data/types.py): video is
channels-last (B, T, H, W, C), uint8 or float in [0, 1]; audio is (B, S)
mono float32 or int16.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Union

import numpy as np
import torch


@dataclass
class ClipBatch:
    """Batch of padded clips; `video_frames`/`audio_samples` are the valid
    extents inside the padded buffers, in frames / samples."""
    video: Any  # (B, T, H, W, C)
    audio: Any  # (B, S)
    video_duration: Any  # (B,) seconds
    audio_duration: Any  # (B,) seconds
    video_frames: Any = None  # (B,) int
    audio_samples: Any = None  # (B,) int

    def to(self, device: Union[str, torch.device]) -> "ClipBatch":
        """Every field as a tensor on `device` (numpy arrays are converted)."""
        def move(x):
            if x is None:
                return None
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return torch.as_tensor(x).to(device)

        return ClipBatch(**{f.name: move(getattr(self, f.name))
                            for f in fields(self)})
