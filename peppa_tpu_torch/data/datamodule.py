"""The data module: train batches and the four validation loaders.

Mirrors the single-process path of peppa_tpu/data/datamodule.py.  The
contract is `prepare_data()`, `setup()`, `train_batches(epoch)` and
`val_loaders()`:

- prepare: with `data.extract`, the episodes of `{data_dir}/in` cut into
  the clip tree (`preprocess/extract.py`); with `data.prepare`, the
  normalisation statistics of the training data to
  `{data_dir}/out/stats.npz`;
- train (dialog, the train episodes, jittered as the config says): an item
  cache (`PeppaPigDataset`), or decoded on the fly with `data.iterable`;
  an epoch's stream is a function of `training.seed + epoch`, shuffled and
  bucketed to `tpu.bucket_durations`, so a resume fast-forwards it.  With
  `tpu.native_loader` (the default) the cache is packed once into
  `items.pack` (`items_i16.pack` with `tpu.pack_audio_int16`) beside it and
  served by the C++ loader (`native/`), which assembles the batches in
  worker threads, into pinned memory on the card; a failed build of the
  loader raises.  Otherwise `bucketed_batches` reads the cache in Python;
- validation, four loaders over item caches: dialog and narration clips of
  fixed duration (`val_rec_fixed`, `valnarr_rec_fixed`), and dialog and
  narration subtitle lines batched by exact audio duration
  (`val_triplet`, `valnarr_triplet`).

Over several processes (`utils/dist.py`) every rank iterates the same
deterministic stream (or the native loader's same plan, before any item is
read) and keeps its slab of each global step through
`multihost_interleave`: every rank gets the same number of batches with the
same shapes, and the ragged tail is dropped.

`SyntheticPigData` fills the datasets with synthetic clips instead.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.decode import FPS
from peppa_tpu_torch.data.dataset import (PeppaPigDataset,
                                          PeppaPigIterableDataset, batches,
                                          bucket_for, bucketed_batches,
                                          collate, grouped_batches)
from peppa_tpu_torch.data.stats import compute_stats, save_stats
from peppa_tpu_torch.data.synthetic import SyntheticClipDataset
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.parallel.mesh import data_axis_of


def multihost_interleave(stream: Iterable, shape_key: Callable,
                         process_index: int, process_count: int) -> Iterator:
    """Regroup a deterministic batch stream for several processes.

    Every process iterates the same stream (same seed, same order) and gets
    back one entry per global step such that at step t all processes hold a
    batch of the same shape; the t-th global batch is the concatenation of
    the processes' batches in rank order.  Entries are grouped by
    `shape_key` in stream order; each complete group of `process_count`
    same-shape entries emits element `process_index`.  Incomplete trailing
    groups are dropped, so every process takes the same number of steps (a
    ragged tail would leave a rank waiting in a collective)."""
    if process_count <= 1:
        yield from stream
        return
    pending = {}
    for entry in stream:
        group = pending.setdefault(shape_key(entry), [])
        group.append(entry)
        if len(group) == process_count:
            yield group[process_index]
            group.clear()


def _batch_shape(batch: ClipBatch) -> Tuple:
    return (tuple(batch.video.shape), tuple(batch.audio.shape))


class PigData:
    """Data module over the extracted episode tree of `data.data_dir`."""

    def __init__(self, config: Config):
        self.config = config
        self.data = config.data

    def prepare_data(self) -> None:
        d = self.data
        if d.extract:
            from peppa_tpu_torch.preprocess.extract import extract

            logging.info("Extracting data for target size %s", d.target_size)
            extract(d.target_size, data_dir=d.data_dir)
        if d.prepare:
            logging.info("Collecting stats on training data.")
            train = PeppaPigIterableDataset(
                target_size=d.target_size,
                audio_sample_rate=d.audio_sample_rate,
                split=["train"], fragment_type="dialog",
                duration=d.train.duration, jitter=d.train.jitter,
                jitter_sd=d.train.jitter_sd, data_dir=d.data_dir)
            save_stats(os.path.join(d.data_dir, "out", "stats.npz"),
                       compute_stats(train))
            logging.info("Saved stats")

    def setup(self) -> None:
        d = self.data
        common = dict(target_size=d.target_size,
                      audio_sample_rate=d.audio_sample_rate,
                      data_dir=d.data_dir)
        train = dict(split=["train"], fragment_type="dialog",
                     duration=d.train.duration, jitter=d.train.jitter,
                     jitter_sd=d.train.jitter_sd, **common)
        self.train = (PeppaPigIterableDataset(**train) if d.iterable else
                      PeppaPigDataset(force_cache=d.train.force_cache,
                                      **train))
        fixed = dict(force_cache=d.val.force_cache, split=["val"],
                     duration=d.val.duration, jitter=d.val.jitter,
                     jitter_sd=d.val.jitter_sd, **common)
        self.val_dia = PeppaPigDataset(fragment_type="dialog", **fixed)
        self.val_narr = PeppaPigDataset(fragment_type="narration", **fixed)
        lines = dict(force_cache=d.val.force_cache, split=["val"],
                     duration=None, jitter=False, **common)
        self.val_dia3 = PeppaPigDataset(fragment_type="dialog", **lines)
        self.val_narr3 = PeppaPigDataset(fragment_type="narration", **lines)

    def _host_shard(self) -> Tuple[int, int]:
        """(this rank's place, their number) among the processes whose
        batches make one global batch: the mesh's data axis (the ranks of
        a data row, which split the model, hold the same rows)."""
        return data_axis_of(self.config)

    def train_batches(self, epoch: int = 0) -> Iterator[ClipBatch]:
        """This rank's batches of epoch `epoch` (every batch, on one
        process)."""
        native = self._native_train_batches(epoch)
        if native is not None:
            yield from native
        else:
            yield from multihost_interleave(self._python_train_batches(epoch),
                                            _batch_shape, *self._host_shard())

    def _python_train_batches(self, epoch: int) -> Iterator[ClipBatch]:
        """Every batch of the epoch, read in Python: the item cache
        shuffled and bucketed, or the stream decoded on the fly."""
        d = self.data
        buckets = tuple(self.config.tpu.bucket_durations)
        if hasattr(self.train, "__len__"):
            yield from bucketed_batches(
                self.train, batch_size=d.train.batch_size, buckets=buckets,
                sample_rate=d.audio_sample_rate, shuffle=d.train.shuffle,
                seed=self.config.training.seed + epoch)
            return
        pending = {b: [] for b in buckets}  # bucket the stream as it comes
        for item in self.train:
            b = bucket_for(max(item.video_duration, item.audio_duration),
                           buckets)
            pending[b].append(item)
            if len(pending[b]) == d.train.batch_size:
                yield collate(
                    pending[b], video_frames=int(round(b * FPS)),
                    audio_samples=int(round(b * d.audio_sample_rate)))
                pending[b] = []

    def _native_train_batches(self, epoch: int
                              ) -> Optional[Iterator[ClipBatch]]:
        """The pack, made beside the item cache on first use, served by the
        native loader; None when `tpu.native_loader` is off or the train set
        has no item cache (`data.iterable`)."""
        cfg = self.config
        d = self.data
        cache_dir = getattr(self.train, "cache_dir", None)
        if not cfg.tpu.native_loader or cache_dir is None:
            return None
        from peppa_tpu_torch.data.cache import pack_from_dataset
        from peppa_tpu_torch.native.loader import (NativeBatchLoader,
                                                   NativePack, bucket_plan)

        pack_path = os.path.join(cache_dir, "items_i16.pack"
                                 if cfg.tpu.pack_audio_int16
                                 else "items.pack")
        if not os.path.exists(pack_path):
            logging.info("Materializing packed cache %s", pack_path)
            pack_from_dataset(self.train, pack_path,
                              audio_int16=cfg.tpu.pack_audio_int16)
        pack = NativePack(pack_path)
        plan = bucket_plan(
            pack.durations(), buckets=tuple(cfg.tpu.bucket_durations),
            batch_size=d.train.batch_size, target_hw=d.target_size,
            sample_rate=d.audio_sample_rate, shuffle=d.train.shuffle,
            seed=cfg.training.seed + epoch)
        # each rank its slot of every complete same-shape group of the plan
        plan = list(multihost_interleave(
            plan, lambda p: (len(p[0]),) + tuple(p[1]), *self._host_shard()))
        logging.info("Native loader: %d batches from %s", len(plan),
                     pack_path)
        return iter(NativeBatchLoader(pack, plan,
                                      n_threads=max(d.num_workers, 1),
                                      depth=cfg.tpu.prefetch * 2))

    def val_loaders(self) -> List[Iterator[ClipBatch]]:
        """The four validation loaders, in the monitors' order."""
        d = self.data
        key = lambda x: x.audio_duration
        return [
            batches(self.val_dia, batch_size=d.val.batch_size),
            batches(self.val_narr, batch_size=d.val.batch_size),
            grouped_batches(self.val_dia3, key, batch_size=d.val.batch_size),
            grouped_batches(self.val_narr3, key, batch_size=d.val.batch_size),
        ]

    def test_loader(self, fragment_type: str = "narration"
                    ) -> Iterator[ClipBatch]:
        """Batches of the test split's clips of `fragment_type`."""
        d = self.data
        ds = PeppaPigDataset(
            force_cache=d.test.force_cache, split=["test"],
            fragment_type=fragment_type, duration=d.test.duration,
            jitter=d.test.jitter, target_size=d.target_size,
            audio_sample_rate=d.audio_sample_rate, data_dir=d.data_dir)
        return batches(ds, batch_size=d.test.batch_size)


class SyntheticPigData(PigData):
    """`PigData` over synthetic clips: `n_train` training clips and
    `n_val` clips in each validation set; the line sets' durations are
    whole seconds from 1 to 3."""

    def __init__(self, config: Config, n_train: int = 64, n_val: int = 32,
                 seed: int = 0, n_classes: int = 8):
        super().__init__(config)
        self.n_train = n_train
        self.n_val = n_val
        self.seed = seed
        self.n_classes = n_classes

    def prepare_data(self) -> None:
        pass

    def setup(self) -> None:
        d = self.data
        dur = d.train.duration or 2.3
        rng = np.random.default_rng(self.seed)
        ts = d.target_size
        sr = d.audio_sample_rate
        k = self.n_classes
        self.train = SyntheticClipDataset([dur] * self.n_train, ts, sr,
                                          seed=self.seed, n_classes=k)
        self.val_dia = SyntheticClipDataset(
            [d.val.duration or 2.3] * self.n_val, ts, sr, seed=self.seed + 1,
            n_classes=k)
        self.val_narr = SyntheticClipDataset(
            [d.val.duration or 2.3] * self.n_val, ts, sr, seed=self.seed + 2,
            n_classes=k)
        line_durs = [float(x) for x in rng.integers(1, 4, size=self.n_val)]
        self.val_dia3 = SyntheticClipDataset(line_durs, ts, sr,
                                             seed=self.seed + 3, n_classes=k)
        self.val_narr3 = SyntheticClipDataset(line_durs, ts, sr,
                                              seed=self.seed + 4, n_classes=k)
