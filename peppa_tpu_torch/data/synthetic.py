"""Synthetic clip data for tests, smoke runs and benchmarks.

Mirrors peppa_tpu/data/synthetic.py: random audio/video clip pairs shaped
like the real pipeline's output, drawn from the same numpy generator with
the same formulas, so an item is bit-identical to the JAX package's;
`make_synthetic_episode_tree` writes an extracted episode tree of `.npz`
clips and subtitle `.json`s whose arrays equal the JAX package's.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from peppa_tpu_torch.data.decode import DEFAULT_SAMPLE_RATE, FPS, save_clip_npz
from peppa_tpu_torch.data.types import Clip

N_CLASSES = 8  # shared latent classes driving both modalities


def correlated_pair(rng: np.random.Generator, k: int, frames: int,
                    samples: int, w: int, h: int, sample_rate: float,
                    video_noise: float = 0.08, audio_noise: float = 0.01,
                    n_classes: int = N_CLASSES):
    """One latent class `k` rendered in both modalities: video a
    class-coloured gradient plus noise, float32 in [0, 1], (frames, h, w,
    3); audio a sine at the class frequency plus noise, float32,
    (samples,).  A contrastive model trained on clips of this family can
    retrieve across held-out items.  With `n_classes != 8` the class
    frequencies are spaced geometrically over [80 Hz, 0.4 * sample_rate];
    the 8-class map is 80 * 2^(k/2)."""
    hue = np.asarray([np.sin(2 * np.pi * (k / n_classes + p))
                      for p in (0.0, 1 / 3, 2 / 3)], np.float32)
    grad = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    base = 0.5 + 0.25 * hue * (0.5 + (k % 2) * grad)
    video = np.clip(base[None] + video_noise * rng.standard_normal(
        (frames, h, w, 3)).astype(np.float32), 0, 1)
    if n_classes == 8:
        freq = 80.0 * (2.0 ** (k / 2.0))
    else:
        top = 0.4 * sample_rate
        freq = 80.0 * (top / 80.0) ** (k / max(n_classes - 1, 1))
    tt = np.arange(samples) / sample_rate
    phase = rng.uniform(0, 2 * np.pi)
    audio = (0.1 * np.sin(2 * np.pi * freq * tt + phase)
             + audio_noise * rng.standard_normal(samples)).astype(np.float32)
    return video, audio


class SyntheticClipDataset:
    """Map-style dataset of random clips with the given durations; item i
    is drawn from `np.random.default_rng(seed * 100003 + i)`, video shipped
    as uint8."""

    def __init__(self, durations: Sequence[float],
                 target_size: Tuple[int, int] = (180, 100),
                 sample_rate: int = DEFAULT_SAMPLE_RATE,
                 fps: float = FPS, seed: int = 0,
                 correlated: bool = True, n_classes: int = N_CLASSES):
        self.durations = list(durations)
        self.target_size = target_size
        self.sample_rate = sample_rate
        self.fps = fps
        self.seed = seed
        self.correlated = correlated  # False: pure noise
        self.n_classes = n_classes

    def __len__(self) -> int:
        return len(self.durations)

    def __getitem__(self, idx: int) -> Clip:
        if idx >= len(self.durations):
            raise IndexError
        rng = np.random.default_rng(self.seed * 100003 + idx)
        dur = self.durations[idx]
        w, h = self.target_size
        t = max(int(round(dur * self.fps)), 1)
        s = max(int(round(dur * self.sample_rate)), 1)
        if self.correlated:
            k = int(rng.integers(0, self.n_classes))
            video, audio = correlated_pair(rng, k, t, s, w, h,
                                           self.sample_rate,
                                           n_classes=self.n_classes)
        else:
            video = np.clip(
                rng.uniform(0, 1, size=(1, h, w, 3)).astype(np.float32)
                + 0.05 * rng.standard_normal((t, h, w, 3)), 0, 1)
            freq = 100.0
            tt = np.arange(s) / self.sample_rate
            phase = rng.uniform(0, 2 * np.pi)
            audio = (0.1 * np.sin(2 * np.pi * freq * tt + phase)
                     + 0.01 * rng.standard_normal(s)).astype(np.float32)
        video_u8 = (np.clip(video, 0, 1) * 255.0).astype(np.uint8)
        return Clip(video=video_u8, audio=audio,
                    video_duration=float(dur), audio_duration=float(dur),
                    filename=f"synthetic://{idx}", index=idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def make_synthetic_episode_tree(data_dir: str,
                                target_size: Tuple[int, int] = (64, 48),
                                fragment_type: str = "dialog",
                                episodes: Sequence[int] = (1, 197),
                                clips_per_episode: int = 2,
                                clip_seconds: float = 7.0,
                                sample_rate: int = 8000,
                                seed: int = 0,
                                correlated: bool = False) -> None:
    """Write {data_dir}/out/{W}x{H}/{fragment}/{ep}/{i}.npz clips, each with
    a .json of subtitle lines every 2-3 s: the layout extraction produces,
    which `PeppaPigIterableDataset` globs.  `correlated=True` draws each
    clip file from the `correlated_pair` family (one latent class a file,
    shared by both modalities) instead of noise, so a model trained on one
    tree evaluates above chance on another."""
    rng = np.random.default_rng(seed)
    w, h = target_size
    fps = FPS
    for ep in episodes:
        base = os.path.join(data_dir, "out", f"{w}x{h}", fragment_type,
                            str(ep))
        os.makedirs(base, exist_ok=True)
        for i in range(clips_per_episode):
            t = int(clip_seconds * fps)
            s = int(clip_seconds * sample_rate)
            if correlated:
                k = int(rng.integers(0, N_CLASSES))
                vf, audio = correlated_pair(rng, k, t, s, w, h, sample_rate)
                video = (np.clip(vf, 0, 1) * 255.0).astype(np.uint8)
            else:
                video = rng.integers(0, 255, size=(t, h, w, 3),
                                     dtype=np.uint8)
                audio = (0.1 * rng.standard_normal(s)).astype(np.float32)
            subs = []
            t0 = 0.0
            j = 0
            while t0 < clip_seconds - 1.0:
                t1 = min(t0 + 2.0 + (j % 2), clip_seconds)
                subs.append({"begin": _ts(t0), "end": _ts(t1),
                             "text": f"line {j}"})
                t0 = t1
                j += 1
            save_clip_npz(os.path.join(base, f"{i}.npz"), video, audio,
                          fps=fps, sample_rate=sample_rate,
                          meta={"subtitles": subs})


def _ts(seconds: float) -> str:
    """`HH:MM:SS.fff`."""
    m, s = divmod(seconds, 60.0)
    hh, mm = divmod(int(m), 60)
    return f"{hh:02d}:{mm:02d}:{s:06.3f}"
