"""Human checks of the triplet tasks.

Mirrors peppa_tpu/evaluation/human_check.py (reference pig/triplet_test.py
and pig/targeted_triplets_test.py), driven from files and the terminal:

- `export_triplets` writes N duration-matched triplets of the val clips as
  anchor.wav + left.mp4 / right.mp4 (the target's side drawn at random and
  kept in answer_key.json);
- `run_terminal_check` walks such an export, asks l/r on the terminal and
  returns the human accuracy;
- `export_targeted_word` writes the minimal-pair clips whose target is a
  word, to judge an eval set by eye.

Videos go through cv2's mp4v writer; where that fails, a PNG strip of the
first frames through matplotlib.  Both are imported when a video is
written.  Runs no model.
"""

from __future__ import annotations

import json
import logging
import os
import random
import wave
from typing import List, Optional, Tuple

import numpy as np


def _write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes((np.clip(samples, -1, 1) * 32767)
                      .astype("<i2").tobytes())


def _write_video(path: str, frames: np.ndarray, fps: float = 10.0) -> bool:
    """(T, H, W, 3) float in [0, 1] or uint8 -> an mp4 through cv2 (True),
    else a PNG strip of up to 8 frames beside it (False)."""
    frames_u8 = (frames if frames.dtype == np.uint8
                 else (np.clip(frames, 0, 1) * 255).astype(np.uint8))
    try:
        import cv2

        h, w = frames_u8.shape[1:3]
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                              fps, (w, h))
        for f in frames_u8:
            out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        out.release()
        return True
    except Exception:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n = min(len(frames_u8), 8)
        fig, axes = plt.subplots(1, n, figsize=(2 * n, 2))
        for ax, f in zip(np.atleast_1d(axes), frames_u8[:n]):
            ax.imshow(f)
            ax.axis("off")
        fig.savefig(os.path.splitext(path)[0] + ".png")
        plt.close(fig)
        return False


def export_triplets(out_dir: str, n: int = 20,
                    fragment_type: str = "narration",
                    target_size: Tuple[int, int] = (180, 100),
                    audio_sample_rate: int = 44100,
                    data_dir: str = "data", seed: int = 0) -> List[dict]:
    """Sample duration-matched triplets of the val clips and export them
    for judging; returns the answer key."""
    from peppa_tpu_torch.data.dataset import PeppaPigDataset
    from peppa_tpu_torch.evaluation.triplet import _triplets

    ds = PeppaPigDataset(target_size=target_size, split=["val"],
                         fragment_type=fragment_type, duration=None,
                         audio_sample_rate=audio_sample_rate,
                         data_dir=data_dir)
    durations = [ds[i].audio_duration for i in range(len(ds))]
    rng = random.Random(seed)
    pairs = _triplets(list(range(len(ds))), durations, rng)
    rng.shuffle(pairs)
    os.makedirs(out_dir, exist_ok=True)
    key = []
    for i, (target, distractor) in enumerate(pairs[:n]):
        d = os.path.join(out_dir, f"{i}")
        os.makedirs(d, exist_ok=True)
        tgt, dis = ds[target], ds[distractor]
        _write_wav(os.path.join(d, "anchor.wav"), tgt.audio,
                   audio_sample_rate)
        target_side = rng.choice(["l", "r"])
        left, right = (tgt, dis) if target_side == "l" else (dis, tgt)
        _write_video(os.path.join(d, "left.mp4"), left.video)
        _write_video(os.path.join(d, "right.mp4"), right.video)
        key.append(dict(index=i, target=target_side,
                        target_file=tgt.filename,
                        distractor_file=dis.filename))
    with open(os.path.join(out_dir, "answer_key.json"), "w") as f:
        json.dump(key, f, indent=2)
    return key


def run_terminal_check(out_dir: str) -> float:
    """Ask l/r for each exported triplet; returns the human accuracy
    (the measurement loop of reference pig/triplet_test.py:14-93)."""
    with open(os.path.join(out_dir, "answer_key.json")) as f:
        key = json.load(f)
    correct = 0
    for entry in key:
        d = os.path.join(out_dir, str(entry["index"]))
        print(f"\nTriplet {entry['index']}: listen to {d}/anchor.wav, "
              f"watch left.mp4 and right.mp4")
        answer = ""
        while answer not in ("l", "r"):
            answer = input("Which video matches the audio? [l/r] ").strip()
        if answer == entry["target"]:
            correct += 1
            print("correct")
        else:
            print("wrong")
    acc = correct / max(len(key), 1)
    print(f"\nHuman accuracy: {acc:.3f} ({correct}/{len(key)})")
    return acc


def export_targeted_word(word: str, out_dir: str,
                         fragment: str = "narration", pos: str = "NOUN",
                         data_dir: str = "data",
                         max_samples: Optional[int] = 10) -> int:
    """Write the minimal-pair clips whose target is `word` (reference
    pig/targeted_triplets_test.py:15-66): the item of each such row's id
    in the eval set's cache, as anchor.wav, positive.mp4, negative.mp4;
    returns their number."""
    from peppa_tpu_torch.evaluation.targeted import (
        PeppaTargetedTripletCachedDataset, _int, get_eval_set_info)

    ds = PeppaTargetedTripletCachedDataset(fragment, pos, data_dir=data_dir)
    _, rows = get_eval_set_info(fragment, pos, data_dir)
    ids = [_int(r["id"]) for r in rows if r.get("target_word") == word]
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for idx in ids:
        if max_samples is not None and n >= max_samples:
            break
        item = ds[idx]
        d = os.path.join(out_dir, f"{word}_{idx}")
        os.makedirs(d, exist_ok=True)
        _write_wav(os.path.join(d, "anchor.wav"), item.anchor, 44100)
        _write_video(os.path.join(d, "positive.mp4"), item.positive)
        _write_video(os.path.join(d, "negative.mp4"), item.negative)
        n += 1
    logging.info("Exported %d samples for word %r to %s", n, word, out_dir)
    return n
