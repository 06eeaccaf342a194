"""Duration-matched triplet scoring.

Mirrors peppa_tpu/evaluation/triplet.py.  Clips are grouped by exact
duration; within each group they are shuffled and paired, and for each pair
one is drawn as the target and the other as the distractor: the model must
place the target video nearer the target's audio than the distractor.

The rounds are drawn on the host with Python's `random.Random(seed)`, by the
JAX package's own code, so a seed gives the same (target, distractor) index
sets in both packages.  Every round is then scored at once on the
embeddings' device: one gather of (rounds, pairs, D) and the cosine.
`TripletScorer` encodes the subtitle-line clips of an episode split and
scores them so.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from peppa_tpu_torch.ops.metrics import triplet_accuracy


def _triplets(indices: Sequence[int], durations: Sequence[float],
              rng: random.Random) -> List[Tuple[int, int]]:
    """One round of duration-matched (target, distractor) pairs."""
    groups: Dict[float, List[int]] = defaultdict(list)
    for i in indices:
        groups[float(durations[i])].append(i)
    out = []
    for dur in sorted(groups):
        items = list(groups[dur])
        rng.shuffle(items)
        for j in range(0, len(items) - 1, 2):
            pair = items[j:j + 2]
            target, distractor = rng.sample(pair, 2)
            out.append((target, distractor))
    return out


def triplet_rounds(duration: Sequence[float], n_samples: int,
                   seed: Optional[int]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(targets, distractors, durations) of `n_samples` rounds: two
    (n_samples, P) int64 index arrays and the (n_samples * P,) target
    durations.  Raises ValueError when no pair can be formed."""
    rng = random.Random(seed)
    durations = np.asarray(duration, np.float64)
    idx = list(range(len(durations)))
    pos_rounds, neg_rounds, dur_rounds = [], [], []
    for _ in range(n_samples):
        pairs = _triplets(idx, durations, rng)
        if not pairs:
            raise ValueError("No duration-matched pairs could be formed")
        p, n = zip(*pairs)
        pos_rounds.append(p)
        neg_rounds.append(n)
        dur_rounds.append(durations[list(p)])
    return (np.asarray(pos_rounds, np.int64), np.asarray(neg_rounds, np.int64),
            np.concatenate(dur_rounds))


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x, device=device)


def score_triplets(video, audio, duration, n_samples: int = 100,
                   seed: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Resampled duration-matched triplet accuracy over embeddings (numpy
    arrays or tensors; scored on the tensors' device):
    {'accuracy': (n_samples,), 'duration': (n_samples * P,)}."""
    video = _as_tensor(video)
    audio = _as_tensor(audio, video.device)
    pos, neg, durs = triplet_rounds(duration, n_samples, seed)
    pos = torch.from_numpy(pos).to(video.device)
    neg = torch.from_numpy(neg).to(video.device)
    with torch.no_grad():
        acc = triplet_accuracy(audio[pos], video[pos], video[neg], dim=2)
        # the round's mean as XLA computes jnp.mean: the sum times the
        # float32 reciprocal of the count, so both packages agree bit for bit
        acc = torch.sum(acc, dim=1) * np.float32(1.0 / acc.shape[1])
    return {"accuracy": acc.cpu().numpy(), "duration": durs}


def comparative_score_triplets(video_set: Sequence, audio_set: Sequence,
                               duration, n_samples: int = 100,
                               seed: Optional[int] = None) -> Dict[str, list]:
    """The same triplet rounds applied to several models' embeddings: the
    continuous similarity differences of each, flattened, and the target
    durations."""
    pos, neg, durs = triplet_rounds(duration, n_samples, seed)
    success = []
    for v, a in zip(video_set, audio_set):
        v = _as_tensor(v)
        a = _as_tensor(a, v.device)
        p = torch.from_numpy(pos).to(v.device)
        n = torch.from_numpy(neg).to(v.device)
        with torch.no_grad():
            diff = triplet_accuracy(a[p], v[p], v[n], dim=2, discrete=False)
        success.append(diff.cpu().numpy().reshape(-1))
    return {"success": success, "duration": durs}


class TripletScorer:
    """Encode the subtitle-line clips (`duration=None`) of an episode split
    and score duration-matched triplets over them.

    Mirrors peppa_tpu/evaluation/triplet.py's `TripletScorer`.  The clips
    come from the item cache (`PeppaPigDataset`, built on first use) in
    batches of one exact audio duration (`grouped_batches`)."""

    def __init__(self, fragment_type: str, split: Sequence[str] = ("val",),
                 target_size: Tuple[int, int] = (180, 100),
                 audio_sample_rate: int = 44100,
                 scrambled_video: bool = False, data_dir: str = "data"):
        from peppa_tpu_torch.data.dataset import PeppaPigDataset

        self.dataset = PeppaPigDataset(
            target_size=target_size, split=list(split),
            fragment_type=fragment_type, duration=None,
            audio_sample_rate=audio_sample_rate,
            scrambled_video=scrambled_video, data_dir=data_dir)

    def _encode(self, predict_fn: Union[torch.nn.Module, Callable],
                batch_size: int,
                device: Optional[Union[str, torch.device]] = None) -> None:
        """A model is run by `eval_step` on `device` (None: the card;
        raises without CUDA), its batches prefetched there; any other
        callable is given each numpy `ClipBatch` and returns an object with
        `.video` and `.audio` embeddings."""
        from peppa_tpu_torch.data.dataset import grouped_batches
        from peppa_tpu_torch.evaluation.validation import encode_loader

        loader = grouped_batches(self.dataset,
                                 key=lambda x: x.audio_duration,
                                 batch_size=batch_size)
        if isinstance(predict_fn, torch.nn.Module):
            enc = encode_loader(predict_fn, loader, device,
                                collect_duration=True)
            self._video, self._audio = enc["video"], enc["audio"]
            self._duration = enc["duration"].cpu().numpy()
            return
        video, audio, duration = [], [], []
        for batch in loader:
            out = predict_fn(batch)
            video.append(_as_tensor(out.video))
            audio.append(_as_tensor(out.audio))
            duration.append(np.asarray(batch.audio_duration))
        self._video = torch.cat(video)
        self._audio = torch.cat(audio)
        self._duration = np.concatenate(duration)

    def _score(self, n_samples: int = 100, seed: Optional[int] = None):
        return score_triplets(self._video, self._audio, self._duration,
                              n_samples=n_samples, seed=seed)

    def evaluate(self, predict_fn: Union[torch.nn.Module, Callable],
                 batch_size: int, n_samples: int = 100,
                 seed: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, np.ndarray]:
        """{'accuracy': (n_samples,), 'duration': (n_samples * P,)}."""
        self._encode(predict_fn, batch_size, device)
        return self._score(n_samples=n_samples, seed=seed)
