"""The packed clip cache: one memory-mappable file for a whole dataset.

Mirrors peppa_tpu/data/cache.py, byte for byte in its layout, so a pack
written by either package is read by the other.  The native loader
(`peppa_tpu_torch/native`) mmaps it and assembles padded batches with
`memcpy`: no pickle, no decode, one page cache for every worker thread.

Layout (little-endian; `native/src/peppa_loader.cpp` reads the same):

    header:  magic 'PPKC' u32 | version u32 | n_items u64
    index:   n_items x { video_off u64 | t,h,w,c u32 | audio_off u64 | s u64 |
                         video_duration f32 | audio_duration f32 }
    payload: each item's uint8 video and its audio samples, in item order

Version 1 stores audio as float32; version 2 as int16,
i = round(clip(f, -1, 1) * 32768), the inverse of the 16-bit wav -> float
scaling of the decode path (half the bytes on disk and to the device).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Tuple

import numpy as np

from peppa_tpu_torch.data.types import Clip

MAGIC = 0x434B5050  # "PPKC"
VERSION = 1
VERSION_I16 = 2
AUDIO_I16_SCALE = 32768.0
_HEADER = struct.Struct("<IIQ")
_ENTRY = struct.Struct("<QIIIIQQff")


def write_pack(path: str, clips: Iterable[Clip],
               audio_int16: bool = False) -> int:
    """Write clips into a pack file; returns the item count.  Float video
    in [0, 1] is quantised x255 as the item cache does; audio is stored as
    float32, or int16 with `audio_int16` (int16 input passes through).
    The file is built under pid-suffixed temporary names and published with
    `os.replace`, so concurrent writers never truncate each other's files
    and a reader never sees a partial pack."""
    tmp = path + f".tmp-{os.getpid()}"
    payload_tmp = path + f".payload-{os.getpid()}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        n = _write_pack_to(tmp, payload_tmp, clips, audio_int16)
    except BaseException:
        for p in (tmp, payload_tmp):
            try:
                os.remove(p)
            except OSError:
                pass
        raise
    os.replace(tmp, path)
    return n


def _pack_audio(audio: np.ndarray, audio_int16: bool) -> np.ndarray:
    a = np.asarray(audio).reshape(-1)
    if not audio_int16:
        return np.ascontiguousarray(a, dtype=np.float32)
    if a.dtype == np.int16:
        return np.ascontiguousarray(a)
    return np.clip(np.round(a.astype(np.float64) * AUDIO_I16_SCALE),
                   -32768, 32767).astype(np.int16)


def _write_pack_to(tmp: str, payload_tmp: str, clips: Iterable[Clip],
                   audio_int16: bool) -> int:
    """The index needs the item count, which a stream of clips gives only
    at its end: the payloads are spooled to a side file, then appended
    behind the header and index."""
    items = []
    with open(payload_tmp, "wb") as pf:
        pos = 0
        for clip in clips:
            video = clip.video
            if video.dtype != np.uint8:
                video = (np.clip(video, 0.0, 1.0) * 255.0).astype(np.uint8)
            audio = _pack_audio(clip.audio, audio_int16)
            t, h, w, c = video.shape
            v_off = pos
            pf.write(np.ascontiguousarray(video).tobytes())
            pos += video.nbytes
            a_off = pos
            pf.write(audio.tobytes())
            pos += audio.nbytes
            items.append((v_off, t, h, w, c, a_off, audio.shape[0],
                          float(clip.video_duration),
                          float(clip.audio_duration)))
    base = _HEADER.size + _ENTRY.size * len(items)
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION_I16 if audio_int16 else VERSION,
                             len(items)))
        for (v_off, t, h, w, c, a_off, s, vd, ad) in items:
            f.write(_ENTRY.pack(base + v_off, t, h, w, c, base + a_off, s,
                                vd, ad))
        with open(payload_tmp, "rb") as pf:
            while True:
                chunk = pf.read(1 << 24)
                if not chunk:
                    break
                f.write(chunk)
    os.remove(payload_tmp)
    return len(items)


class PackReader:
    """numpy memmap reader of a pack (no native code)."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        magic, version, n = _HEADER.unpack_from(
            self._mm[:_HEADER.size].tobytes())
        if magic != MAGIC or version not in (VERSION, VERSION_I16):
            raise ValueError(f"not a pack file: {path}")
        self.version = version
        self.audio_dtype = np.int16 if version == VERSION_I16 else np.float32
        self.n_items = n
        raw = self._mm[_HEADER.size:_HEADER.size + _ENTRY.size * n].tobytes()
        self._entries = [_ENTRY.unpack_from(raw, i * _ENTRY.size)
                         for i in range(n)]

    def __len__(self) -> int:
        return self.n_items

    def meta(self, i: int
             ) -> Tuple[Tuple[int, int, int, int], int, float, float]:
        v_off, t, h, w, c, a_off, s, vd, ad = self._entries[i]
        return (t, h, w, c), s, vd, ad

    def __getitem__(self, i: int) -> Clip:
        """Item i: uint8 video and audio in the pack's dtype, as stored."""
        v_off, t, h, w, c, a_off, s, vd, ad = self._entries[i]
        bps = np.dtype(self.audio_dtype).itemsize
        audio = np.frombuffer(self._mm[a_off:a_off + s * bps].tobytes(),
                              dtype=self.audio_dtype)
        return Clip(video=self.raw_video(i), audio=audio,
                    video_duration=vd, audio_duration=ad, index=i)

    def raw_video(self, i: int) -> np.ndarray:
        v_off, t, h, w, c, *_ = self._entries[i]
        return np.asarray(self._mm[v_off:v_off + t * h * w * c]
                          ).reshape(t, h, w, c)

    def durations(self) -> np.ndarray:
        """(n_items, 2) float32: video and audio duration of each item."""
        return np.asarray([(e[7], e[8]) for e in self._entries], np.float32)


def pack_from_dataset(dataset, path: str, audio_int16: bool = False) -> int:
    """Write any iterable of clips (such as a `PeppaPigDataset`) as a
    pack."""
    return write_pack(path, iter(dataset), audio_int16=audio_int16)
