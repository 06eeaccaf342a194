"""Host-side media decode.

Mirrors peppa_tpu/data/decode.py.  Backends:

- `.npz` clip files (the interchange format that extraction and
  `make_synthetic_episode_tree` write) decode with numpy alone;
- video frames of other files through cv2 (ffmpeg-backed), audio through
  the `ffmpeg` binary, else the `wave` module for `.wav` and the
  pure-Python PCM-in-AVI reader (`data/avi.py`) for `.avi`.

cv2 and ffmpeg are optional and looked up when a non-`.npz` file is
decoded, never at import; without them such a file raises `RuntimeError`.
Audio is resampled linearly to `sample_rate` (44.1 kHz by default) and
averaged to mono.  The `.npz` arithmetic is the JAX package's, so both
give the same arrays: frames `video[i0:max(i1, i0 + 1)]` with
`i = round(t * fps)`, as float32 / 255; audio sliced at `round(t * sr)`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np

from peppa_tpu_torch.data.types import Clip, RawSegment

DEFAULT_SAMPLE_RATE = 44100
FPS = 10  # frames per second of the extracted episodes


def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def media_duration(path: str) -> float:
    """Duration in seconds of a media or .npz clip file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return float(z["duration"])
    if have_cv2():
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            fps = cap.get(cv2.CAP_PROP_FPS) or FPS
            frames = cap.get(cv2.CAP_PROP_FRAME_COUNT)
            return float(frames / fps) if fps else 0.0
        finally:
            cap.release()
    raise RuntimeError(f"No decode backend for {path}")


def decode_video_frames(path: str, start: float, end: float,
                        target_size: Optional[Tuple[int, int]] = None
                        ) -> np.ndarray:
    """Frames in [start, end) as (T, H, W, 3) float32 in [0, 1]."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            video = z["video"]  # (T, H, W, 3) uint8
            fps = float(z.get("fps", FPS))
        i0, i1 = int(round(start * fps)), int(round(end * fps))
        frames = video[i0:max(i1, i0 + 1)]
        return frames.astype(np.float32) / 255.0
    if not have_cv2():
        raise RuntimeError("OpenCV not available for video decode")
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or FPS
        i0, i1 = int(round(start * fps)), int(round(end * fps))
        cap.set(cv2.CAP_PROP_POS_FRAMES, i0)
        frames = []
        for _ in range(max(i1 - i0, 1)):
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if target_size is not None:
                frame = cv2.resize(frame, target_size,
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
        if not frames:
            raise ValueError("Clip has zero frames.")
        return np.stack(frames).astype(np.float32) / 255.0
    finally:
        cap.release()


def decode_audio(path: str, start: float, end: float,
                 sample_rate: int = DEFAULT_SAMPLE_RATE) -> np.ndarray:
    """Mono audio samples in [start, end) as (S,) float32."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            audio = z["audio"].astype(np.float32)  # (S,) at z['sample_rate']
            sr = int(z.get("sample_rate", sample_rate))
        a = audio[int(round(start * sr)):int(round(end * sr))]
        if sr != sample_rate:
            a = resample_linear(a, sr, sample_rate)
        return a
    if path.endswith(".wav") and not have_ffmpeg():
        return _read_wav(path, start, end, sample_rate)
    if path.endswith(".avi") and not have_ffmpeg():
        from peppa_tpu_torch.data.avi import read_avi_audio

        audio, sr = read_avi_audio(path)
        a = audio[int(round(start * sr)):int(round(end * sr))]
        if sr != sample_rate:
            a = resample_linear(a, sr, sample_rate)
        return a
    if have_ffmpeg():
        cmd = ["ffmpeg", "-v", "error", "-ss", f"{start:.6f}", "-t",
               f"{end - start:.6f}", "-i", path, "-f", "f32le", "-acodec",
               "pcm_f32le", "-ac", "1", "-ar", str(sample_rate), "-"]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        return np.frombuffer(out, dtype=np.float32).copy()
    raise RuntimeError(f"No audio decode backend for {path}")


def _read_wav(path: str, start: float, end: float,
              sample_rate: int) -> np.ndarray:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        i0 = min(int(start * sr), n)
        i1 = min(int(end * sr), n)
        w.setpos(i0)
        raw = w.readframes(i1 - i0)
    if width == 2:
        a = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        a = np.frombuffer(raw, dtype=np.int32).astype(np.float32) \
            / 2147483648.0
    else:
        a = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) / 128.0 - 1.0
    if ch > 1:
        a = a.reshape(-1, ch).mean(axis=1)
    if sr != sample_rate:
        a = resample_linear(a, sr, sample_rate)
    return a


def resample_linear(a: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """`a` at `sr_out` by linear interpolation (`np.interp`)."""
    if sr_in == sr_out or a.size == 0:
        return a
    n_out = int(round(a.size * sr_out / sr_in))
    x_out = np.linspace(0.0, a.size - 1, n_out)
    return np.interp(x_out, np.arange(a.size), a).astype(np.float32)


def decode_segment(seg: RawSegment, sample_rate: int = DEFAULT_SAMPLE_RATE,
                   target_size: Optional[Tuple[int, int]] = None) -> Clip:
    """A `RawSegment` decoded into a `Clip` (float32 video in [0, 1])."""
    video = decode_video_frames(seg.path, seg.video_start, seg.video_end,
                                target_size)
    audio = decode_audio(seg.path, seg.audio_start, seg.audio_end, sample_rate)
    return Clip(video=video, audio=audio,
                video_duration=seg.duration,
                audio_duration=seg.audio_duration,
                filename=seg.path, offset=seg.offset)


def load_clip_npz(path: str) -> Clip:
    """A whole .npz clip file as a `Clip`."""
    with np.load(path) as z:
        video = z["video"].astype(np.float32)
        if video.max() > 1.5:  # stored as 0-255
            video = video / 255.0
        audio = z["audio"].astype(np.float32)
        sr = int(z.get("sample_rate", DEFAULT_SAMPLE_RATE))
        fps = float(z.get("fps", FPS))
    return Clip(video=video, audio=audio,
                video_duration=video.shape[0] / fps,
                audio_duration=audio.shape[0] / sr,
                filename=path)


def save_clip_npz(path: str, video_uint8: np.ndarray, audio: np.ndarray,
                  fps: float = FPS, sample_rate: int = DEFAULT_SAMPLE_RATE,
                  meta: Optional[dict] = None) -> None:
    """Write a clip in the .npz interchange format (and `meta`, such as
    the subtitles, as a .json beside it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, video=video_uint8, audio=audio.astype(np.float32),
        fps=np.float32(fps), sample_rate=np.int32(sample_rate),
        duration=np.float32(video_uint8.shape[0] / fps))
    if meta is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(meta, f)
