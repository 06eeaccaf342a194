"""The general traffic generators: inputs from a mix's parameters and the
run's seed.  The same seed gives the same inputs; every seed gives the same
amount of work per step or request in distribution.

- `train`: micro-step i's bucket follows each bucket of `bucket_cycle`
  once (so the first micro-steps warm every shape), then seeded shuffles
  of the cycle; its B clips' durations are N(`duration_mean_s`,
  `duration_sd_s`) drawn inside the bucket, (the next smaller bucket
  duration or `duration_min_s`, the bucket], and its video (uint8 noise)
  and audio (normal noise times `audio_scale`) are drawn on the device,
  zero past each clip's length.
- `serve`: `pool` requests of `pairs_per_request` clips made on the host;
  the clips' durations are the quantiles (j + 1/2) / n of a log-normal
  (median `duration_median_s`, sigma `duration_log_sigma`) clipped to
  `duration_clip_s`, the same set for every seed, dealt to the requests in
  a seeded order; requests are sent in seeded permutations of the pool,
  one every 1 / `rate_per_s` seconds.  A pool about as large as the
  requests a window sends keeps the tail of their latencies from hanging
  on a few heavy requests that each seed would draw anew.
- `encode`: one base batch of `batch` whole clips of `duration_s` drawn on
  the device; batch i is the base with its video XOR a byte and its audio
  times 1 +- 1e-3, both drawn from (seed, i).
"""

from __future__ import annotations

import itertools
import math
import statistics
from typing import Dict, Iterator, List

import numpy as np
import torch

FPS = 10.0


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint32)[0])


def buckets(hp: dict) -> List[float]:
    return [float(b) for b in hp["tpu"]["bucket_durations"]]


def shape(hp: dict, seconds: float):
    """(frames, samples) of `seconds`."""
    return (int(round(seconds * FPS)),
            int(round(seconds * hp["data"]["audio_sample_rate"])))


# ----------------------------------------------------------------- train
def train_buckets(traffic: dict, seed: int) -> Iterator[float]:
    cycle = [float(b) for b, n in traffic["bucket_cycle"] for _ in range(n)]
    yield from (float(b) for b, _ in traffic["bucket_cycle"])
    rng = np.random.default_rng([seed, 1])
    while True:
        yield from (cycle[j] for j in rng.permutation(len(cycle)))


def train_plan(traffic: dict, seed: int, n: int) -> List[float]:
    return list(itertools.islice(train_buckets(traffic, seed), n))


def _durations(traffic: dict, hp: dict, bucket: float, n: int,
               rng: np.random.Generator) -> np.ndarray:
    below = [b for b in buckets(hp) if b < bucket]
    lo = max(below) if below else float(traffic["duration_min_s"])
    out = np.empty(n)
    for j in range(n):
        while True:
            d = rng.normal(traffic["duration_mean_s"], traffic["duration_sd_s"])
            if lo < d <= bucket:
                out[j] = d
                break
    return out


def train_batch(traffic: dict, hp: dict, seed: int, i: int, bucket: float,
                rows: int, device) -> Dict[str, torch.Tensor]:
    """Micro-step i's batch on `device`: {"video", "audio", "video_frames",
    "audio_samples", "durations"}."""
    d = _durations(traffic, hp, bucket, rows,
                   np.random.default_rng([seed, 2, i]))
    frames, samples = shape(hp, bucket)
    vf = np.clip(np.rint(d * FPS), 1, frames).astype(np.int32)
    sa = np.clip(np.rint(d * hp["data"]["audio_sample_rate"]), 1,
                 samples).astype(np.int32)
    w, h = hp["data"]["target_size"]
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 3, i))
    video = torch.randint(0, 256, (rows, frames, h, w, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    audio = torch.randn((rows, samples), generator=gen, device=device)
    vf_t = torch.from_numpy(vf).to(device)
    sa_t = torch.from_numpy(sa).to(device)
    video *= (torch.arange(frames, device=device)[None, :] < vf_t[:, None]
              ).to(torch.uint8)[:, :, None, None, None]
    audio *= ((torch.arange(samples, device=device)[None, :] < sa_t[:, None])
              * float(traffic["audio_scale"]))
    return {"video": video, "audio": audio, "video_frames": vf_t,
            "audio_samples": sa_t,
            "durations": torch.from_numpy(d.astype(np.float32)).to(device)}


# ----------------------------------------------------------------- serve
def serve_requests(traffic: dict, hp: dict, seed: int) -> List[dict]:
    """The pool: each request {"video": [uint8 (T, H, W, 3)], "audio":
    [float32 (S,)], "durations": [s]}.  The clips are views, at seeded
    offsets, into one video and one audio buffer of twice the longest
    clip, so a large pool costs the host little."""
    rng = np.random.default_rng([seed, 4])
    w, h = hp["data"]["target_size"]
    lo, hi = traffic["duration_clip_s"]
    pairs = int(traffic["pairs_per_request"])
    n = int(traffic["pool"]) * pairs
    normal = statistics.NormalDist()
    durations = rng.permutation(np.clip(
        [traffic["duration_median_s"] * math.exp(
            traffic["duration_log_sigma"] * normal.inv_cdf((j + 0.5) / n))
         for j in range(n)], lo, hi))
    frames_max, samples_max = shape(hp, hi)
    video_buf = rng.integers(0, 256, (2 * frames_max, h, w, 3),
                             dtype=np.uint8)
    audio_buf = (rng.standard_normal(2 * samples_max, dtype=np.float32)
                 * np.float32(traffic["audio_scale"]))
    pool = []
    for r in range(traffic["pool"]):
        d = durations[r * pairs:(r + 1) * pairs]
        video, audio = [], []
        for x in d:
            frames, samples = shape(hp, float(x))
            frames = max(frames, 1)
            at = int(rng.integers(0, 2 * frames_max - frames + 1))
            video.append(video_buf[at:at + frames])
            at = int(rng.integers(0, 2 * samples_max - samples + 1))
            audio.append(audio_buf[at:at + samples])
        pool.append({"video": video, "audio": audio, "durations": d})
    return pool


def serve_order(traffic: dict, seed: int) -> Iterator[int]:
    rng = np.random.default_rng([seed, 5])
    while True:
        yield from (int(j) for j in rng.permutation(traffic["pool"]))


# ---------------------------------------------------------------- encode
def encode_base(traffic: dict, hp: dict, seed: int, device):
    """(video uint8 (B, T, H, W, 3), audio (B, S)) of the base batch."""
    frames, samples = shape(hp, traffic["duration_s"])
    w, h = hp["data"]["target_size"]
    b = traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 6))
    video = torch.randint(0, 256, (b, frames, h, w, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    audio = torch.randn((b, samples), generator=gen, device=device)
    return video, audio * float(traffic["audio_scale"])


def encode_variant(seed: int, i: int):
    """(video byte, audio scale) of batch i."""
    rng = np.random.default_rng([seed, 7, i])
    return int(rng.integers(0, 256)), float(1.0 + rng.uniform(-1e-3, 1e-3))


def encode_batch(base_video, base_audio, seed: int, i: int):
    byte, scale = encode_variant(seed, i)
    return torch.bitwise_xor(base_video, byte), base_audio * scale
