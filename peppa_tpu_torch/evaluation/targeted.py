"""Targeted (minimal-pairs) triplets: the eval-set clips, their cache, and
per-sample scoring.

Mirrors peppa_tpu/evaluation/targeted.py:

- `get_eval_set_info`: `data/eval/eval_set_{fragment}_{pos}.csv`, read
  with the `csv` module (no pandas);
- `PeppaTargetedTripletDataset.from_csv`: cuts each row's clip
  [clipStart, clipEnd) from its episode into
  `data/out/val_{fragment}_targeted_triplets_{pos}/{id}.npz`, writes
  `clip_info.json` and `sample.json`, and pairs each clip (the target)
  with its counterexample's (the distractor);
- `PeppaTargetedTripletCachedDataset`: the item cache
  `data/out/items-targeted-triplets-{W}-{H}-{fragment}-{sr}-{pos}/{i}.npz`
  (anchor, positive, negative, audio_duration, video_duration); the
  scrambled control shuffles the frames of both videos with
  `np.random.default_rng(scramble_seed)`;
- `targeted_triplet_score`: triplet accuracy per sample through the
  model's `TripletBatch` forward.

The JAX package's files and the port's are the same.  The CSV's floats
are parsed by `csv_float`, a copy of pandas' default C parser (it is not
correctly rounded beyond 15 digits), so clip boundaries and the floats in
`clip_info.json` are those of the JAX package; an empty cell is NaN, as
pandas reads it.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from peppa_tpu_torch.data import decode as D
from peppa_tpu_torch.data.dataset import atomic_cache_build, pad_to
from peppa_tpu_torch.data.types import Triplet, TripletBatch
from peppa_tpu_torch.ops.metrics import triplet_accuracy

FPS = 10  # reference targeted_triplets.py:16
_POW10 = [float(f"1e{k}") for k in range(309)]


def csv_float(text: str) -> float:
    """A float as pandas' `read_csv` parses it by default (its
    `precise_xstrtod`): at most 17 significant digits accumulated in a
    double, then one multiply or divide by a power of ten."""
    s = text.strip()
    i, n = 0, len(s)
    negative = i < n and s[i] == "-"
    if i < n and s[i] in "+-":
        i += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while i < n and s[i].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        while digits < 17 and i < n and s[i].isdigit():
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while i < n and s[i].isdigit():
            i += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {text!r}")
    if negative:
        number = -number
    if i < n and s[i] in "eE":
        i += 1
        e_negative = i < n and s[i] == "-"
        if i < n and s[i] in "+-":
            i += 1
        e, e_digits = 0, 0
        while e_digits < 17 and i < n and s[i].isdigit():
            e = e * 10 + ord(s[i]) - 48
            e_digits += 1
            i += 1
        exponent += -e if e_negative else e
    if i != n:
        raise ValueError(f"not a number: {text!r}")
    if exponent > 308:
        return -np.inf if negative else np.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def get_eval_set_info(fragment: str, pos: str, data_dir: str = "data"
                      ) -> Tuple[List[str], List[Dict[str, str]]]:
    """(the columns, the rows as dicts of cell text) of an eval-set CSV;
    the `id` column first, as its index."""
    path = os.path.join(data_dir, "eval", f"eval_set_{fragment}_{pos}.csv")
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        columns = list(reader.fieldnames or [])
    if "id" not in columns:
        raise ValueError(f"{path} has no id column")
    columns = ["id"] + [c for c in columns if c != "id"]
    return columns, rows


def _cell(row: Dict[str, str], key: str):
    """A text cell as pandas gives it: absent None, empty NaN."""
    if key not in row:
        return None
    return row[key] if row[key] != "" else float("nan")


def _int(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        return int(csv_float(text))


class PeppaTargetedTripletDataset:
    """Cuts and serves (target, distractor) clip pairs from the eval CSV."""

    def __init__(self, directory: str,
                 target_size: Tuple[int, int] = (180, 100),
                 audio_sample_rate: int = 44100):
        self.directory = directory
        self.target_size = tuple(target_size)
        self.audio_sample_rate = audio_sample_rate
        self._clip_info: Dict[int, dict] = {}
        self._sample: List[Tuple[dict, dict]] = []

    @classmethod
    def from_csv(cls, fragment: str, pos: str,
                 target_size: Tuple[int, int] = (180, 100),
                 audio_sample_rate: int = 44100,
                 data_dir: str = "data") -> "PeppaTargetedTripletDataset":
        directory = os.path.join(
            data_dir, "out", f"val_{fragment}_targeted_triplets_{pos}")
        self = cls(directory, target_size, audio_sample_rate)
        _, rows = get_eval_set_info(fragment, pos, data_dir)
        self._load_eval_set_and_save_clip_info(rows)
        self._sample = list(self.sample())
        self._save_sample()
        return self

    def _load_eval_set_and_save_clip_info(self, rows: List[Dict[str, str]]
                                          ) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._clip_info = {}
        for row in rows:
            id_ = _int(row["id"])
            path_example = os.path.join(self.directory, f"{id_}.npz")
            start, end = csv_float(row["clipStart"]), csv_float(row["clipEnd"])
            video = D.decode_video_frames(row["episode_filepath"], start, end,
                                          self.target_size)
            audio = D.decode_audio(row["episode_filepath"], start, end,
                                   self.audio_sample_rate)
            D.save_clip_npz(path_example,
                            (np.clip(video, 0, 1) * 255).astype(np.uint8),
                            audio, fps=FPS, sample_rate=self.audio_sample_rate)
            self._clip_info[id_] = dict(
                path=path_example,
                transcript=_cell(row, "transcript"),
                target_word=_cell(row, "target_word"),
                distractor_word=_cell(row, "distractor_word"),
                id_counterexample=_int(row["id_counterexample"]),
                audio_start=start, audio_end=end,
                duration=end - start)
        with open(os.path.join(self.directory, "clip_info.json"), "w") as f:
            json.dump({str(k): v for k, v in self._clip_info.items()}, f,
                      indent=2)

    def sample(self) -> Iterator[Tuple[dict, dict]]:
        for item in self._clip_info.values():
            yield (item, self._clip_info[item["id_counterexample"]])

    def _save_sample(self) -> None:
        with open(os.path.join(self.directory, "sample.json"), "w") as f:
            json.dump(self._sample, f, indent=2)

    def __len__(self) -> int:
        return len(self._sample)

    def __getitem__(self, idx: int) -> Triplet:
        target_info, distractor_info = self._sample[idx]
        pos_clip = D.load_clip_npz(target_info["path"])
        neg_clip = D.load_clip_npz(distractor_info["path"])
        return Triplet(anchor=pos_clip.audio, positive=pos_clip.video,
                       negative=neg_clip.video,
                       audio_duration=pos_clip.audio_duration,
                       video_duration=pos_clip.video_duration)


class PeppaTargetedTripletCachedDataset:
    """The targeted triplets' item cache, built on first use."""

    def __init__(self, fragment: str, pos: str,
                 target_size: Tuple[int, int] = (180, 100),
                 audio_sample_rate: int = 44100, force_cache: bool = False,
                 scrambled_video: bool = False, data_dir: str = "data",
                 scramble_seed: Optional[int] = None):
        self.cache_dir = os.path.join(
            data_dir, "out",
            f"items-targeted-triplets-{target_size[0]}-{target_size[1]}-"
            f"{fragment}-{audio_sample_rate}-{pos}")

        def build(tmp: str) -> None:
            ds = PeppaTargetedTripletDataset.from_csv(
                fragment, pos, target_size, audio_sample_rate, data_dir)
            for i in range(len(ds)):
                item = ds[i]
                logging.info("Caching item %s/%d.npz", self.cache_dir, i)
                np.savez(os.path.join(tmp, f"{i}.npz"),
                         anchor=item.anchor.astype(np.float32),
                         positive=(np.clip(item.positive, 0, 1) * 255
                                   ).astype(np.uint8),
                         negative=(np.clip(item.negative, 0, 1) * 255
                                   ).astype(np.uint8),
                         audio_duration=np.float32(item.audio_duration or 0),
                         video_duration=np.float32(item.video_duration or 0))

        atomic_cache_build(self.cache_dir, build, force=force_cache)
        self.length = len(glob.glob(os.path.join(self.cache_dir, "*.npz")))
        self.scrambled_video = scrambled_video
        self._rng = np.random.default_rng(scramble_seed)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Triplet:
        with np.load(os.path.join(self.cache_dir, f"{idx}.npz")) as z:
            item = Triplet(anchor=z["anchor"].astype(np.float32),
                           positive=z["positive"], negative=z["negative"],
                           audio_duration=float(z["audio_duration"]),
                           video_duration=float(z["video_duration"]))
        if self.scrambled_video:
            # both videos shuffled along time, independently
            item.positive = item.positive[
                self._rng.permutation(item.positive.shape[0])]
            item.negative = item.negative[
                self._rng.permutation(item.negative.shape[0])]
        return item


def collate_triplets(items: List[Triplet]) -> TripletBatch:
    """Zero-pad to the batch's longest anchor and video, and stack."""
    smax = max(x.anchor.shape[0] for x in items)
    t = max(max(x.positive.shape[0] for x in items),
            max(x.negative.shape[0] for x in items))
    return TripletBatch(
        anchor=np.stack([pad_to(x.anchor, smax, 0) for x in items]),
        positive=np.stack([pad_to(x.positive, t, 0) for x in items]),
        negative=np.stack([pad_to(x.negative, t, 0) for x in items]))


def targeted_triplet_score(fragment: str, pos: str, predict_fn: Callable,
                           batch_size: int = 8, scrambled_video: bool = False,
                           target_size: Tuple[int, int] = (180, 100),
                           audio_sample_rate: int = 44100,
                           data_dir: str = "data") -> np.ndarray:
    """Triplet accuracy per sample (1, 0, or 0.5 on a tie) in the eval
    set's order, float64 as the JAX package returns it.  `predict_fn` maps a numpy `TripletBatch` to its
    embeddings (`evaluation.make_predict`)."""
    ds = PeppaTargetedTripletCachedDataset(
        fragment, pos, target_size, audio_sample_rate,
        scrambled_video=scrambled_video, data_dir=data_dir, scramble_seed=666)
    results: List[torch.Tensor] = []
    for lo in range(0, len(ds), batch_size):
        batch = collate_triplets([ds[i] for i in
                                  range(lo, min(lo + batch_size, len(ds)))])
        out = predict_fn(batch)
        with torch.inference_mode():
            results.append(triplet_accuracy(
                torch.as_tensor(out.anchor), torch.as_tensor(out.positive),
                torch.as_tensor(out.negative)).float().cpu())
    if not results:
        return np.zeros((0,), np.float64)
    return torch.cat(results).numpy().astype(np.float64)
