"""Episode extraction: cut dialog and narration clips from whole episodes.

Mirrors peppa_tpu/preprocess/extract.py (reference pig/preprocess.py):

- `extract` reads the episode list CSV (`data/in/peppa_pig_dataset-
  video_list.csv`) and every annotation `data/in/peppa/episodes/*.json`,
  and `extract_from_episode` cuts each contiguous tokenized span of each
  part (`narrator_splits[].{context, narration}.tokenized`), resized to
  the target size and decimated to 10 fps, into
  `data/out/{W}x{H}/{dialog,narration}/{episode}/{i}.{npz,avi}` with the
  part's annotation as `{i}.json` beside it;
- `extract_realines` re-cuts each realigned utterance
  (`data/out/realign/*/ep_*/*/*.json`) from its first to its last aligned
  word, and writes the clip beside the JSON.

Containers: `.npz` (uint8 frames and float32 audio at 44.1 kHz, which the
pipeline decodes with numpy alone) or `.avi` (mpeg4 video through cv2 and
PCM16 audio, `data/avi.py`, the reference's own clip format).  Decoding the
episodes needs cv2 for the frames of a media file, and ffmpeg or the
`wave` / AVI readers for its audio (`data/decode.py`).  Time stamps are
parsed by `data/segment.py::total_seconds`, to the floats
`pd.Timedelta(...).total_seconds()` gives; pandas reads the episode list.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from itertools import groupby
from typing import Dict, Optional, Tuple

import numpy as np

from peppa_tpu_torch.data import decode as D
from peppa_tpu_torch.data.segment import total_seconds

FPS = 10  # reference pig/preprocess.py:46


def episode_titles(data_dir: str = "data") -> Dict[str, str]:
    """Map episode title -> media path (reference pig/preprocess.py:12-14);
    the list's paths lose their first four characters ("mnt/")."""
    import pandas as pd

    csv_path = os.path.join(data_dir, "in", "peppa_pig_dataset-video_list.csv")
    data = pd.read_csv(csv_path, sep=";", quotechar="'",
                       names=["id", "title", "path"], index_col=0)
    return dict(zip(data["title"],
                    data["path"].map(
                        lambda x: os.path.join(data_dir, "in", "peppa", x[4:]))))


def extract(target_size: Tuple[int, int] = (180, 100),
            data_dir: str = "data", container: str = "npz") -> None:
    """Extract every annotated episode (reference pig/preprocess.py:10-22);
    `container="avi"` writes the reference's clip format."""
    titles = episode_titles(data_dir)
    episodes = glob.glob(os.path.join(data_dir, "in", "peppa", "episodes",
                                      "*.json"))
    for path in episodes:
        with open(path) as f:
            annotation = json.load(f)
        extract_from_episode(annotation, titles[annotation["title"]],
                             target_size, data_dir, container=container)


def _cut(video_path: str, begin: float, end: float,
         target_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 frames at 10 fps, 44.1 kHz audio) of [begin, end)."""
    video = D.decode_video_frames(video_path, begin, end,
                                  target_size=target_size)
    # decimate to 10 fps: the decoder returns source-fps frames
    src_fps = video.shape[0] / max(end - begin, 1e-6)
    idx = np.round(np.arange(0, video.shape[0], src_fps / FPS)).astype(int)
    video = video[idx[idx < video.shape[0]]]
    audio = D.decode_audio(video_path, begin, end)
    return (np.clip(video, 0, 1) * 255).astype(np.uint8), audio


def extract_realines(target_size: Tuple[int, int] = (180, 100),
                     data_dir: str = "data", container: str = "npz") -> None:
    """Re-cut each realigned utterance from its first to its last
    successfully aligned word, offset by its `clipStart` (reference
    pig/preprocess.py:74-89), into a clip beside its JSON."""
    items = []
    for path in glob.glob(os.path.join(data_dir, "out", "realign", "*",
                                       "ep_*", "*", "*.json")):
        with open(path) as f:
            meta = json.load(f)
        meta["path"] = path
        if "episode_filepath" in meta:
            items.append(meta)
    items.sort(key=lambda x: x["episode_filepath"])
    for episode_path, metas in groupby(items,
                                       key=lambda x: x["episode_filepath"]):
        for meta in metas:
            fully = [w for w in meta.get("words", [])
                     if w.get("case") == "success"]
            if not fully:
                continue
            start = fully[0]["start"] + meta["clipStart"]
            end = fully[-1]["end"] + meta["clipStart"]
            video, audio = _cut(episode_path, start, end, target_size)
            _write_clip(os.path.splitext(meta["path"])[0], video, audio,
                        container)


def _write_clip(path_base: str, video_uint8: np.ndarray, audio: np.ndarray,
                container: str, meta: Optional[dict] = None,
                sample_rate: int = D.DEFAULT_SAMPLE_RATE) -> str:
    """One clip as `.npz` or as `.avi` (mpeg4 + PCM16), with `meta` as the
    `.json` beside it; returns the clip's path."""
    if container == "avi":
        from peppa_tpu_torch.data.avi import write_clip_avi

        out = path_base + ".avi"
        write_clip_avi(out, video_uint8, audio, fps=FPS, rate=sample_rate)
        if meta is not None:
            with open(path_base + ".json", "w") as f:
                json.dump(meta, f)
        return out
    out = path_base + ".npz"
    D.save_clip_npz(out, video_uint8, audio, fps=FPS, meta=meta)
    return out


def extract_from_episode(annotation: dict, video_path: str,
                         target_size: Tuple[int, int],
                         data_dir: str = "data",
                         container: str = "npz") -> None:
    """Cut one episode's dialog and narration spans (reference
    pig/preprocess.py:25-57)."""
    width, height = target_size
    spans = {"dialog": [], "narration": []}
    for segment in annotation["narrator_splits"]:
        for kind, key in (("dialog", "context"), ("narration", "narration")):
            tokenized = segment[key]["tokenized"]
            if tokenized:
                spans[kind].append((total_seconds(tokenized[0]["begin"]),
                                    total_seconds(tokenized[-1]["end"]),
                                    segment[key]))
    for kind, items in spans.items():
        outdir = os.path.join(data_dir, "out", f"{width}x{height}", kind,
                              str(annotation["id"]))
        os.makedirs(outdir, exist_ok=True)
        for i, (begin, end, meta) in enumerate(items):
            logging.info("Writing %s %d from episode %s", kind, i,
                         annotation["id"])
            video, audio = _cut(video_path, begin, end, (width, height))
            _write_clip(os.path.join(outdir, str(i)), video, audio,
                        container, meta=meta)
