"""Audio-only and whole-file loaders for analysis embeddings.

Mirrors peppa_tpu/data/audio.py: host-side generators of padded batches of
(S,) waveforms, from files (decoded to mono at `audio_sample_rate`) or
arrays; the grouped variants batch within groups of equal length, so a
batch holds no padding.  `videofile_loader` gives `ClipBatch`es of whole
media files.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence

import numpy as np

from peppa_tpu_torch.data import decode as D
from peppa_tpu_torch.data.dataset import collate, grouped, pad_to
from peppa_tpu_torch.data.types import RawSegment

DEFAULT_SAMPLE_RATE = D.DEFAULT_SAMPLE_RATE


def collate_audio(items: Sequence[np.ndarray]) -> np.ndarray:
    """Zero-pad (S,) waveforms to the batch's longest and stack -> (B, S)."""
    arrays = [np.asarray(a, np.float32).reshape(-1) for a in items]
    smax = max(a.shape[0] for a in arrays)
    return np.stack([pad_to(a, smax, 0) for a in arrays])


def audio_files(paths: Sequence[str],
                audio_sample_rate: int = DEFAULT_SAMPLE_RATE
                ) -> Iterator[np.ndarray]:
    """Whole audio files as mono (S,) float32 waveforms."""
    for path in paths:
        end = D.media_duration(path) if not path.endswith(".wav") else 1e9
        yield D.decode_audio(path, 0.0, end, audio_sample_rate)


def _batched(items: Iterator, batch_size: int,
             collate_fn: Callable) -> Iterator:
    buf: List = []
    for item in items:
        buf.append(item)
        if len(buf) == batch_size:
            yield collate_fn(buf)
            buf = []
    if buf:
        yield collate_fn(buf)


def audiofile_loader(paths: Sequence[str], batch_size: int = 32,
                     audio_sample_rate: int = DEFAULT_SAMPLE_RATE):
    return _batched(audio_files(paths, audio_sample_rate), batch_size,
                    collate_audio)


def audioarray_loader(arrays: Sequence[np.ndarray], batch_size: int = 32):
    return _batched(iter(arrays), batch_size, collate_audio)


def grouped_audio_loader(items, batch_size: int = 32,
                         key: Callable = lambda x: np.asarray(x).shape[-1]):
    """Batches within groups of equal `key` (the length)."""
    for _, group in grouped(list(items), key=key):
        yield from _batched(iter(list(group)), batch_size, collate_audio)


def grouped_audiofile_loader(paths: Sequence[str], batch_size: int = 32,
                             audio_sample_rate: int = DEFAULT_SAMPLE_RATE):
    return grouped_audio_loader(audio_files(paths, audio_sample_rate),
                                batch_size)


def grouped_audioarray_loader(arrays, batch_size: int = 32):
    return grouped_audio_loader(arrays, batch_size)


def video_files(paths: Sequence[str],
                audio_sample_rate: int = DEFAULT_SAMPLE_RATE):
    """Whole media files decoded to `Clip`s."""
    for path in paths:
        duration = D.media_duration(path)
        yield D.decode_segment(
            RawSegment(path=path, video_start=0.0, video_end=duration,
                       audio_start=0.0, audio_end=duration),
            audio_sample_rate)


def videofile_loader(paths: Sequence[str], batch_size: int = 32,
                     audio_sample_rate: int = DEFAULT_SAMPLE_RATE):
    """Padded `ClipBatch`es of whole media files."""
    return _batched(video_files(paths, audio_sample_rate), batch_size,
                    collate)
