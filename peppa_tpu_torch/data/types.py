"""Data containers of the port (tensors, no pytree registration).

Layouts follow the JAX package (peppa_tpu/data/types.py): video is
channels-last (T, H, W, C) / batched (B, T, H, W, C), uint8 or float in
[0, 1]; audio is (S,) / batched (B, S) mono float32 or int16.  `Clip` holds
one item as numpy arrays; the batches hold numpy arrays or tensors, and
`to(device)` gives tensors on a device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Optional, Union

import numpy as np
import torch


def _move(x, device):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device)


@dataclass
class Clip:
    """A video clip with its audio."""
    video: np.ndarray  # (T, H, W, C) uint8, or float32 in [0, 1]
    audio: np.ndarray  # (S,) float32
    video_duration: float
    audio_duration: float
    filename: str = ""
    offset: Optional[float] = None
    index: Optional[int] = None


@dataclass
class RawSegment:
    """An undecoded segment of a source clip: spans in seconds from the
    start of the file; the audio and video spans may differ (jittered
    segmentation)."""
    path: str
    video_start: float
    video_end: float
    audio_start: float
    audio_end: float
    offset: Optional[float] = None
    meta: Any = None

    @property
    def duration(self) -> float:
        return self.video_end - self.video_start

    @property
    def audio_duration(self) -> float:
        return self.audio_end - self.audio_start


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
        return ClipBatch(**{f.name: _move(getattr(self, f.name), device)
                            for f in fields(self)})


@dataclass
class Triplet:
    """(anchor audio, positive video, negative video)."""
    anchor: Any
    positive: Any
    negative: Any
    video_duration: Optional[float] = None
    audio_duration: Optional[float] = None


@dataclass
class TripletBatch:
    """Padded batch of triplets: the forward embeds the anchor with the
    audio tower and both videos with the video tower, with no lengths."""
    anchor: Any  # (B, S)
    positive: Any  # (B, T, H, W, C)
    negative: Any  # (B, T, H, W, C)

    def to(self, device: Union[str, torch.device]) -> "TripletBatch":
        """Every field as a tensor on `device` (numpy arrays are converted)."""
        return TripletBatch(**{f.name: _move(getattr(self, f.name), device)
                               for f in fields(self)})


@dataclass
class Stats:
    """Mean and standard deviation of a data sample: per video channel,
    and over all audio samples."""
    video_mean: np.ndarray  # (3,)
    video_std: np.ndarray  # (3,)
    audio_mean: float
    audio_std: float
