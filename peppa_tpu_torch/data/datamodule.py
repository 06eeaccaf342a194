"""The data module: train batches and the four validation loaders.

Mirrors the single-process branch of peppa_tpu/data/datamodule.py.  The
contract is `prepare_data()`, `setup()`, `train_batches(epoch)` and
`val_loaders()`:

- train: shuffled by `training.seed + epoch` and bucketed to
  `tpu.bucket_durations`, so an epoch's stream is a function of the seed and
  the epoch (resume fast-forwards it);
- validation, four loaders: dialog and narration clips of fixed duration
  (`val_rec_fixed`, `valnarr_rec_fixed`), and dialog and narration
  subtitle lines batched by exact audio duration (`val_triplet`,
  `valnarr_triplet`).

`SyntheticPigData` fills the datasets with synthetic clips; `PigData` over
the extracted episodes waits for the port's dataset classes and raises.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.dataset import (batches, bucketed_batches,
                                          grouped_batches)
from peppa_tpu_torch.data.synthetic import SyntheticClipDataset
from peppa_tpu_torch.data.types import ClipBatch


class PigData:
    """Data module over the extracted episode tree."""

    def __init__(self, config: Config):
        self.config = config
        self.data = config.data

    def prepare_data(self) -> None:
        pass

    def setup(self) -> None:
        raise NotImplementedError(
            "training on the extracted episodes needs the port's dataset "
            "classes, which come in a later slice; use SyntheticPigData")

    def train_batches(self, epoch: int = 0) -> Iterator[ClipBatch]:
        d = self.data
        yield from bucketed_batches(
            self.train, batch_size=d.train.batch_size,
            buckets=tuple(self.config.tpu.bucket_durations),
            sample_rate=d.audio_sample_rate, shuffle=d.train.shuffle,
            seed=self.config.training.seed + epoch)

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
