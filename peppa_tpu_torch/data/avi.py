"""A minimal AVI (RIFF) reader and writer for PCM16 audio beside a video
stream, in the standard library's `struct`.

Mirrors peppa_tpu/data/avi.py.  `mux_pcm_audio` adds a PCM16 mono stream,
interleaved frame by frame with a rebuilt idx1, to a video-only AVI (such as
cv2.VideoWriter writes, which cannot mux audio); `read_avi_audio` reads the
audio back, so decode reads `.avi` clips' audio without ffmpeg.
`write_clip_avi` needs cv2 for the video essence and imports it when
called.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np


def _chunks(buf: bytes, start: int, end: int):
    """Iterate (fourcc, payload_start, payload_size) over a RIFF chunk run."""
    pos = start
    while pos + 8 <= end:
        fourcc = buf[pos:pos + 4]
        (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def parse_avi(buf: bytes):
    """Return (avih_payload, [strl_list_bytes...], [stream frame chunks]).

    Frame chunks are (stream_fourcc, payload_bytes) in movi order.
    """
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    avih = None
    strls: List[bytes] = []
    frames: List[Tuple[bytes, bytes]] = []
    for fourcc, p, size in _chunks(buf, 12, len(buf)):
        if fourcc != b"LIST":
            continue
        kind = buf[p:p + 4]
        if kind == b"hdrl":
            for f2, p2, s2 in _chunks(buf, p + 4, p + size):
                if f2 == b"avih":
                    avih = buf[p2:p2 + s2]
                elif f2 == b"LIST" and buf[p2:p2 + 4] == b"strl":
                    strls.append(buf[p2 - 8:p2 + s2 + (s2 & 1)])
        elif kind == b"movi":
            for f2, p2, s2 in _chunks(buf, p + 4, p + size):
                if f2[2:4] in (b"dc", b"db", b"wb"):
                    frames.append((f2, buf[p2:p2 + s2]))
    if avih is None:
        raise ValueError("no avih header")
    return avih, strls, frames


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def _audio_strl(rate: int, n_samples: int) -> bytes:
    block = 2  # PCM16 mono
    strh = struct.pack(
        "<4s4sIHHIIIIIIiI4H",
        b"auds", b"\x00\x00\x00\x00",
        0, 0, 0, 0,
        block, rate * block,       # dwScale, dwRate: rate/scale = samples/s
        0, n_samples,              # dwStart, dwLength (in blocks)
        rate * block, -1,          # dwSuggestedBufferSize, dwQuality
        block, 0, 0, 0, 0)         # dwSampleSize, rcFrame
    strf = struct.pack("<HHIIHHH", 1, 1, rate, rate * block, block, 16, 0)
    return _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))


def mux_pcm_audio(video_avi: bytes, audio: np.ndarray, rate: int) -> bytes:
    """Return a two-stream AVI: the input's video + `audio` as PCM16 mono.

    `audio` is float in [-1, 1] or int16; it is sliced per video frame so
    players can interleave without seeking.
    """
    avih, strls, frames = parse_avi(video_avi)
    if len(strls) != 1:
        raise ValueError(f"expected a video-only AVI, got {len(strls)} streams")
    if audio.dtype != np.int16:
        audio = (np.clip(np.asarray(audio, np.float32), -1, 1)
                 * 32767).astype("<i2")
    audio = audio.astype("<i2").tobytes()

    # dwMicroSecPerFrame -> fps for the per-frame audio slice size
    (usec,) = struct.unpack("<I", avih[:4])
    n_video = len(frames)
    fps = 1e6 / usec if usec else 10.0
    # whole int16 samples per frame (x2 bytes): an odd byte count would split
    # a PCM16 sample across '01wb' chunks, desyncing block-aligned parsers
    bytes_per_frame = int(round(rate / fps)) * 2

    avih2 = bytearray(avih)
    struct.pack_into("<I", avih2, 24, 2)  # dwStreams = 2
    hdrl = (_chunk(b"avih", bytes(avih2)) + strls[0]
            + _audio_strl(rate, len(audio) // 2))

    movi = bytearray(b"movi")
    index = []
    pos_audio = 0
    for i, (fourcc, payload) in enumerate(frames):
        index.append((fourcc, len(movi) - 4, len(payload)))
        movi += _chunk(fourcc, payload)
        lo = pos_audio
        hi = min(lo + bytes_per_frame, len(audio))
        if i == n_video - 1:
            hi = len(audio)  # remainder rides the last frame
        if hi > lo:
            index.append((b"01wb", len(movi) - 4, hi - lo))
            movi += _chunk(b"01wb", audio[lo:hi])
            pos_audio = hi

    idx1 = bytearray()
    for fourcc, off, size in index:
        # AVIOLDINDEX offsets are relative to the start of 'movi' + 4
        idx1 += struct.pack("<4sIII", fourcc, 0x10, off + 4, size)

    body = _list(b"hdrl", hdrl) + _list(b"movi", bytes(movi[4:]))
    body += _chunk(b"idx1", bytes(idx1))
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body


def read_avi_audio(path: str) -> Tuple[np.ndarray, int]:
    """(float32 mono audio, sample_rate) from a PCM-in-AVI file."""
    with open(path, "rb") as f:
        buf = f.read()
    _, strls, frames = parse_avi(buf)
    rate = None
    for strl in strls:
        for f2, p2, s2 in _chunks(strl, 12, len(strl)):
            if f2 == b"strf" and s2 >= 16:
                tag, ch, r = struct.unpack("<HHI", strl[p2:p2 + 8])
                if tag == 1:  # PCM
                    rate = r
    if rate is None:
        raise ValueError("no PCM audio stream")
    pcm = b"".join(p for f, p in frames if f == b"01wb")
    audio = np.frombuffer(pcm, "<i2").astype(np.float32) / 32767.0
    return audio, rate


def write_clip_avi(path: str, video_uint8: np.ndarray, audio: np.ndarray,
                   fps: int, rate: int) -> None:
    """Write frames+audio as a reference-consumable mpeg4 .avi.

    video_uint8: (T, H, W, 3) RGB.  Uses cv2 for the mpeg4 video essence,
    then muxes PCM16 audio in-process (no ffmpeg needed).
    """
    import os
    import tempfile

    import cv2

    t, h, w, _ = video_uint8.shape
    fd, tmp = tempfile.mkstemp(suffix=".avi",
                               dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        writer = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h), True)
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open (mp4v)")
        for frame in video_uint8:
            writer.write(frame[:, :, ::-1])  # RGB -> BGR
        writer.release()
        with open(tmp, "rb") as f:
            video_only = f.read()
        muxed = mux_pcm_audio(video_only, audio, rate)
        with open(tmp, "wb") as f:
            f.write(muxed)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
