"""Normalisation statistics over the training data, in two passes.

Mirrors peppa_tpu/data/stats.py: per-channel video mean and standard
deviation and the global audio ones, the mean in a first pass and the sum
of squared errors in a second, in float64 sums.  uint8 video counts as
float32 / 255.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from peppa_tpu_torch.data.types import Clip, Stats


def _as_float(v: np.ndarray) -> np.ndarray:
    return v.astype(np.float32) / 255.0 if v.dtype == np.uint8 else v


def compute_stats(dataset: Iterable[Clip]) -> Stats:
    video_sum = np.zeros(3, np.float64)
    video_count = 0.0
    audio_sum = 0.0
    audio_count = 0.0
    items = list(dataset)
    for clip in items:
        video_sum += _as_float(clip.video).reshape(-1, 3).sum(axis=0)
        video_count += clip.video.size / 3
        audio_sum += float(clip.audio.sum())
        audio_count += clip.audio.size
    video_mean = video_sum / video_count
    audio_mean = audio_sum / audio_count

    video_sse = np.zeros(3, np.float64)
    audio_sse = 0.0
    for clip in items:
        video_sse += ((_as_float(clip.video).reshape(-1, 3) - video_mean) ** 2
                      ).sum(axis=0)
        audio_sse += float(((clip.audio - audio_mean) ** 2).sum())
    return Stats(video_mean=video_mean.astype(np.float32),
                 video_std=np.sqrt(video_sse / video_count).astype(np.float32),
                 audio_mean=float(audio_mean),
                 audio_std=float(np.sqrt(audio_sse / audio_count)))


def save_stats(path: str, stats: Stats) -> None:
    np.savez(path, video_mean=stats.video_mean, video_std=stats.video_std,
             audio_mean=np.float32(stats.audio_mean),
             audio_std=np.float32(stats.audio_std))


def load_stats(path: str) -> Stats:
    with np.load(path) as z:
        return Stats(video_mean=z["video_mean"], video_std=z["video_std"],
                     audio_mean=float(z["audio_mean"]),
                     audio_std=float(z["audio_std"]))
