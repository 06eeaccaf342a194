"""Batching: collation, duration-grouped and duration-bucketed batches.

Mirrors the batching half of peppa_tpu/data/dataset.py.  Batches are numpy
`ClipBatch`es, as in the JAX package; the caller moves them to a device
(`ClipBatch.to`).  The dataset classes over extracted episodes and their
cache wait for the port's decoder.
"""

from __future__ import annotations

from itertools import groupby
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from peppa_tpu_torch.data.synthetic import DEFAULT_SAMPLE_RATE, FPS
from peppa_tpu_torch.data.types import Clip, ClipBatch


def pad_to(x: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """`x` cropped or zero-padded to `size` along `axis`."""
    if x.shape[axis] >= size:
        slicer = [slice(None)] * x.ndim
        slicer[axis] = slice(0, size)
        return x[tuple(slicer)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - x.shape[axis])
    return np.pad(x, pad)


def collate(clips: Sequence[Clip],
            video_frames: Optional[int] = None,
            audio_samples: Optional[int] = None) -> ClipBatch:
    """Zero-pad to the batch's longest clip, or to the given bucket sizes,
    and stack; the valid extents go into `video_frames` / `audio_samples`."""
    vf = [c.video.shape[0] for c in clips]
    sa = [c.audio.shape[0] for c in clips]
    tv = video_frames if video_frames is not None else max(vf)
    ta = audio_samples if audio_samples is not None else max(sa)
    video = np.stack([pad_to(c.video, tv, 0) for c in clips])
    audio = np.stack([pad_to(c.audio, ta, 0) for c in clips])
    return ClipBatch(
        video=video, audio=audio,
        video_duration=np.asarray([c.video_duration for c in clips],
                                  np.float32),
        audio_duration=np.asarray([c.audio_duration for c in clips],
                                  np.float32),
        video_frames=np.asarray([min(f, tv) for f in vf], np.int32),
        audio_samples=np.asarray([min(s, ta) for s in sa], np.int32))


def grouped(items, key):
    """itertools.groupby over the items sorted by `key`."""
    return groupby(sorted(items, key=key), key=key)


def grouped_batches(dataset, key: Callable, batch_size: int = 8,
                    collate_fn: Callable = collate) -> Iterator[ClipBatch]:
    """Batches formed within groups of equal key (such as the exact audio
    duration), so a batch holds no padding."""
    for _, group in grouped(list(dataset), key=key):
        group = list(group)
        for i in range(0, len(group), batch_size):
            yield collate_fn(group[i:i + batch_size])


def batches(dataset, batch_size: int = 8, shuffle: bool = False,
            seed: int = 0, drop_last: bool = False,
            collate_fn: Callable = collate) -> Iterator[ClipBatch]:
    """Batches in order, or shuffled by `np.random.default_rng(seed)`."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, n, batch_size):
        idx = order[i:i + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate_fn([dataset[int(j)] for j in idx])


def bucket_for(value: float, buckets: Sequence[float]) -> float:
    """The smallest bucket >= value (the last bucket if none fits)."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def bucketed_batches(dataset, batch_size: int, buckets: Sequence[float],
                     fps: float = FPS, sample_rate: int = DEFAULT_SAMPLE_RATE,
                     shuffle: bool = False, seed: int = 0,
                     drop_last: bool = True) -> Iterator[ClipBatch]:
    """Items grouped by duration bucket and padded to the bucket's shape:
    one batch shape per bucket."""
    n = len(dataset)
    order = np.arange(n)
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    pending = {b: [] for b in buckets}
    for j in order:
        item = dataset[int(j)]
        b = bucket_for(max(item.video_duration, item.audio_duration), buckets)
        pending[b].append(item)
        if len(pending[b]) == batch_size:
            yield collate(pending[b],
                          video_frames=int(round(b * fps)),
                          audio_samples=int(round(b * sample_rate)))
            pending[b] = []
    if not drop_last:
        for b, items in pending.items():
            if items:
                yield collate(items, video_frames=int(round(b * fps)),
                              audio_samples=int(round(b * sample_rate)))
