"""Datasets over the extracted episodes, their item cache, and batching.

Mirrors peppa_tpu/data/dataset.py:

- `PeppaPigIterableDataset`: glob the split's clips, segment them (fixed,
  jittered or subtitle lines), decode; zero-frame clips are skipped with a
  warning; `shard(index, count)` takes a contiguous range of the files;
- `PeppaPigDataset`: built once into an `items-{config_id()}` directory of
  `{i}.npz` items (video as uint8, quantised from the decoded float32 as the
  JAX package does), then served by index; `scrambled_video` permutes
  frames; the same directory name as the JAX package's, so either package
  reads the other's cache;
- collation, duration-grouped, plain and duration-bucketed batches.

Batches are numpy `ClipBatch`es, as in the JAX package; the caller moves
them to a device.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import pickle
import random
import shutil
from itertools import groupby
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from peppa_tpu_torch.data import decode as D
from peppa_tpu_torch.data.decode import DEFAULT_SAMPLE_RATE, FPS
from peppa_tpu_torch.data.segment import lines, segment
from peppa_tpu_torch.data.types import Clip, ClipBatch

# fragment type -> split -> episode numbers
SPLIT_SPEC = {
    "dialog": {"train": range(1, 197), "val": range(197, 210), "test": None},
    "narration": {"val": range(1, 105), "test": range(105, 210),
                  "train": None},
}


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


# ---------------------------------------------------------------- datasets
class PeppaPigIterableDataset:
    """Decode-on-the-fly dataset over the extracted episode clips of
    `{data_dir}/out/{W}x{H}/{fragment_type}/{episode}/`.  With no `seed`
    the jitter draws from the global `random` module, as the JAX
    package's does."""

    def __init__(self,
                 split: Sequence[str] = ("val",),
                 target_size: Tuple[int, int] = (180, 100),
                 fragment_type: str = "dialog",
                 duration: Optional[float] = 3.2,
                 audio_sample_rate: int = DEFAULT_SAMPLE_RATE,
                 jitter: bool = False,
                 jitter_sd: Optional[float] = None,
                 data_dir: str = "data",
                 seed: Optional[int] = None):
        if isinstance(split, str):
            raise ValueError("`split` should be a list of strings")
        self.split = list(split)
        self.target_size = tuple(target_size)
        self.fragment_type = fragment_type
        self.duration = duration
        self.audio_sample_rate = audio_sample_rate
        self.jitter = jitter
        self.jitter_sd = jitter_sd
        self.data_dir = data_dir
        self._shard = (0, 1)
        self._rng = random.Random(seed) if seed is not None else None

    def config_id(self) -> str:
        """The item cache's key (the JAX package's string)."""
        return "-".join([
            ",".join(self.split),
            f"{self.target_size[0]}x{self.target_size[1]}",
            self.fragment_type,
            f"{self.duration}",
            f"{self.audio_sample_rate}",
            f"{self.jitter},{self.jitter_sd}" if self.jitter else "",
        ])

    def shard(self, index: int, count: int) -> "PeppaPigIterableDataset":
        self._shard = (index, count)
        return self

    def _paths(self) -> List[str]:
        w, h = self.target_size
        paths = []
        for split in self.split:
            episodes = SPLIT_SPEC[self.fragment_type][split]
            if episodes is None:
                continue
            for ep in episodes:
                base = os.path.join(self.data_dir, "out", f"{w}x{h}",
                                    self.fragment_type, str(ep))
                paths.extend(sorted(glob.glob(os.path.join(base, "*.avi"))))
                paths.extend(sorted(glob.glob(os.path.join(base, "*.npz"))))
        if not paths:
            raise RuntimeError(
                f"No clips found in {self.data_dir}/out/{w}x{h}/"
                f"{self.fragment_type}/ . Extract the data first.")
        index, count = self._shard
        per = int(math.ceil(len(paths) / count))
        return paths[index * per:min((index + 1) * per, len(paths))]

    def _raw_segments(self) -> Iterator:
        for path in self._paths():
            try:
                clip_duration = D.media_duration(path)
            except Exception as e:  # an unreadable file is skipped
                logging.warning("Cannot read %s: %s", path, e)
                continue
            if self.duration is None:
                with open(os.path.splitext(path)[0] + ".json") as f:
                    meta = json.load(f)
                yield from lines(path, clip_duration, meta)
            else:
                yield from segment(path, clip_duration, duration=self.duration,
                                   jitter=self.jitter, jitter_sd=self.jitter_sd,
                                   rng=self._rng)

    def __iter__(self) -> Iterator[Clip]:
        for seg in self._raw_segments():
            try:
                yield D.decode_segment(seg, self.audio_sample_rate)
            except ValueError as e:
                logging.warning("%s", e)  # zero-frame clips are skipped


def _has_items(d: str) -> bool:
    return bool(glob.glob(os.path.join(d, "*.npz")))


def atomic_cache_build(cache_dir: str, build_fn: Callable[[str], None],
                       force: bool = False) -> None:
    """Populate an item cache directory atomically: `build_fn(tmp_dir)`
    writes the `{i}.npz` items into a pid-suffixed temporary directory,
    published to `cache_dir` with `os.replace` only when the build
    completed and wrote at least one item.

    - A build that raises, or writes no item, leaves nothing behind.
    - A `cache_dir` holding items is reused; one holding none is rebuilt.
    - Concurrent builders race benignly: the loser drops its directory and
      uses the winner's.
    """
    if not force and _has_items(cache_dir):
        return
    tmp = cache_dir + f".building-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        build_fn(tmp)
        if not _has_items(tmp):
            raise RuntimeError(
                f"Cache build for {cache_dir} produced no items: the source "
                "dataset matched nothing (wrong split/fragment/data_dir, or "
                "every clip failed to decode).")
        if os.path.isdir(cache_dir) and (force or not _has_items(cache_dir)):
            shutil.rmtree(cache_dir)
        try:
            os.replace(tmp, cache_dir)
        except OSError:
            if _has_items(cache_dir):  # a concurrent builder published first
                shutil.rmtree(tmp, ignore_errors=True)
                return
            raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class PeppaPigDataset:
    """Map-style dataset over an item cache, built from a
    `PeppaPigIterableDataset` of the keyword arguments on first use."""

    def __init__(self, force_cache: bool = False,
                 cache_dir: Optional[str] = None,
                 scrambled_video: bool = False, data_dir: str = "data",
                 scramble_seed: Optional[int] = None, **kwargs):
        self.data_dir = data_dir
        if cache_dir is None:
            source: Optional[PeppaPigIterableDataset] = \
                PeppaPigIterableDataset(data_dir=data_dir, **kwargs)
            self.cache_dir = os.path.join(
                data_dir, "out", f"items-{source.config_id()}")
        else:
            self.cache_dir = cache_dir
            source = (PeppaPigIterableDataset(data_dir=data_dir, **kwargs)
                      if kwargs else None)

        def build(tmp: str) -> None:
            if source is None:
                raise RuntimeError(
                    f"No cache at {self.cache_dir} and no source config")
            with open(os.path.join(tmp, "settings.pkl"), "wb") as f:
                pickle.dump(kwargs, f)
            for i, item in enumerate(source):
                logging.info("Caching item %s/%d.npz", self.cache_dir, i)
                self._save_item_in(tmp, i, item)

        atomic_cache_build(self.cache_dir, build, force=force_cache)
        self.length = len(glob.glob(os.path.join(self.cache_dir, "*.npz")))
        if self.length == 0:  # cache_dir passed in but empty, no source
            raise RuntimeError(
                f"Item cache {self.cache_dir} holds no clips. "
                "Remove the dir to force a rebuild.")
        self.scrambled_video = scrambled_video
        self._scramble_rng = np.random.default_rng(scramble_seed)

    @staticmethod
    def _save_item_in(dirname: str, i: int, item: Clip) -> None:
        # uint8 from the decoded float32 by numpy's float32 arithmetic, as
        # the JAX package stores it (a value can floor one below round())
        video = (item.video if item.video.dtype == np.uint8
                 else (np.clip(item.video, 0, 1) * 255).astype(np.uint8))
        np.savez(os.path.join(dirname, f"{i}.npz"),
                 video=video,
                 audio=item.audio.astype(np.float32),
                 video_duration=np.float32(item.video_duration),
                 audio_duration=np.float32(item.audio_duration),
                 filename=np.bytes_(item.filename.encode()))

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Clip:
        if idx >= self.length:
            raise IndexError("Index out of range")
        with np.load(os.path.join(self.cache_dir, f"{idx}.npz")) as z:
            item = Clip(video=z["video"], audio=z["audio"],
                        video_duration=float(z["video_duration"]),
                        audio_duration=float(z["audio_duration"]),
                        filename=z["filename"].tobytes().decode(
                            errors="ignore"),
                        index=idx)
        if self.scrambled_video:
            perm = self._scramble_rng.permutation(item.video.shape[0])
            item.video = item.video[perm]
        return item

    @classmethod
    def load(cls, directory: str) -> "PeppaPigDataset":
        return cls(force_cache=False, cache_dir=directory)

    def __iter__(self) -> Iterator[Clip]:
        for i in range(self.length):
            yield self[i]

    @classmethod
    def import_reference_cache(cls, torch_cache_dir: str, cache_dir: str
                               ) -> "PeppaPigDataset":
        """Convert a reference `items-*/{i}.pt` cache (pickled clips with
        (C, T, H, W) video) into an `.npz` item cache."""
        import torch

        os.makedirs(cache_dir, exist_ok=True)
        paths = sorted(glob.glob(os.path.join(torch_cache_dir, "*.pt")),
                       key=lambda p: int(os.path.splitext(
                           os.path.basename(p))[0]))
        for i, p in enumerate(paths):
            item = torch.load(p, map_location="cpu", weights_only=False)
            video = np.transpose(np.asarray(item.video), (1, 2, 3, 0))
            clip = Clip(video=video,
                        audio=np.asarray(item.audio).reshape(-1),
                        video_duration=float(item.video_duration),
                        audio_duration=float(item.audio_duration),
                        filename=str(getattr(item, "filename", "")))
            cls._save_item_in(cache_dir, i, clip)
        return cls(cache_dir=cache_dir)
