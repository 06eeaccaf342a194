"""Clip segmentation: fixed windows, jittered windows, subtitle lines.

Mirrors peppa_tpu/data/segment.py, over (path, duration, metadata)
descriptors; decoding happens later.

- `segment`: non-overlapping windows of `duration` seconds while the window
  fits.
- `segment_jitter`: per window, audio and video span lengths drawn
  independently from N(duration, sd), clamped to [0.05, 6.0] s, both
  centred on the window's midpoint and clipped to the clip.
- `lines`: split at the subtitle boundaries of the sidecar JSON, relative to
  the first subtitle, the difference floored to whole seconds (the
  reference's `Timedelta(...).seconds`), the end clamped to the clip; a line
  starting past the end is skipped with a warning.

The JAX package reads the time stamps with `pd.Timedelta`; the port parses
them itself (`total_seconds`), to the same float, so it needs no pandas.
"""

from __future__ import annotations

import logging
import math
import random
import re
from typing import Dict, Iterator, Optional

from peppa_tpu_torch.data.types import RawSegment

JITTER_MIN_S = 0.05
JITTER_MAX_S = 6.0

_STAMP = re.compile(r"\s*(\d+):(\d+):(\d+)(?:\.(\d+))?\s*")


def total_seconds(stamp: str) -> float:
    """Seconds of an `H:MM:SS[.fraction]` time stamp, as
    `pd.Timedelta(stamp).total_seconds()` gives them: the stamp to whole
    nanoseconds, truncated to microseconds, over 10**6.  Raises ValueError
    on any other form (pandas rejects `MM:SS.fff` too)."""
    m = _STAMP.fullmatch(stamp)
    if m is None:
        raise ValueError(f"not an H:MM:SS[.fraction] time stamp: {stamp!r}")
    h, mi, s, frac = m.groups()
    ns = ((int(h) * 60 + int(mi)) * 60 + int(s)) * 10**9
    if frac:
        ns += int(frac[:9].ljust(9, "0"))
    return (ns // 1000) / 10**6


def segment(path: str, clip_duration: float, duration: float = 3.2,
            jitter: bool = False, jitter_sd: Optional[float] = None,
            rng: Optional[random.Random] = None) -> Iterator[RawSegment]:
    """Fixed or jittered non-overlapping windows over [0, clip_duration]."""
    if jitter:
        yield from segment_jitter(path, clip_duration, duration,
                                  sd=jitter_sd, rng=rng)
        return
    start = 0.0
    end = start + duration
    while end <= clip_duration:
        yield RawSegment(path=path, video_start=start, video_end=end,
                         audio_start=start, audio_end=end, offset=start)
        start = end
        end = end + duration


def segment_jitter(path: str, clip_duration: float, duration: float = 3.2,
                   sd: Optional[float] = 1.0,
                   rng: Optional[random.Random] = None
                   ) -> Iterator[RawSegment]:
    """Windows with independently jittered audio and video spans around
    each midpoint; draws from `rng`, else the global `random` module."""
    if sd is None:
        sd = 1.0
    rng = rng or random
    start = 0.0
    end = start + duration
    while end <= clip_duration:
        size_a = min(JITTER_MAX_S, max(JITTER_MIN_S,
                                       duration + rng.normalvariate(0.0, sd)))
        size_v = min(JITTER_MAX_S, max(JITTER_MIN_S,
                                       duration + rng.normalvariate(0.0, sd)))
        mid = end - (end - start) / 2
        a0 = max(0.0, mid - size_a / 2)
        a1 = min(clip_duration, mid + size_a / 2)
        v0 = max(0.0, mid - size_v / 2)
        v1 = min(clip_duration, mid + size_v / 2)
        yield RawSegment(path=path, video_start=v0, video_end=v1,
                         audio_start=a0, audio_end=a1, offset=start)
        start = end
        end = end + duration


def lines(path: str, clip_duration: float,
          metadata: Dict) -> Iterator[RawSegment]:
    """A clip split at its subtitle boundaries (module doc)."""
    subs = metadata["subtitles"]
    if not subs:
        return
    start = total_seconds(subs[0]["begin"])
    for line in subs:
        begin = float(math.floor(total_seconds(line["begin"]) - start))
        end = min(clip_duration,
                  float(math.floor(total_seconds(line["end"]) - start)))
        if begin < clip_duration:
            yield RawSegment(path=path, video_start=begin, video_end=end,
                             audio_start=begin, audio_end=end, offset=begin,
                             meta=line)
        else:
            logging.warning("Line %s starts past end of clip %s", line, path)
