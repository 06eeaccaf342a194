"""The measured window, its traced part, and the trace's reduction.

`Window` times the measured window on the host clock.  In a traced run
its first half runs as an untraced run does (the per-layer metrics read
from counters, spans and the host clock come from it) and its second half
under `torch.profiler` (CPU and CUDA activity, shapes recorded): the
profiler's own cost would otherwise be in every rate of the run.

`reduce_trace` turns the profiler's events into what the per-layer readers
take: the union of the card's kernel, copy and set intervals (busy time),
the idle gaps between them named by the benchmark's range and the
innermost host operation open when each began, the device operations that
took most time, and each call of a named operator with its input shapes,
dtypes and the device time of the kernels it launched.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

RANGES = ("train_step", "embed_audio", "embed_video", "similarity",
          "encode_score")  # the benchmark's own ranges around each layer
OPERATORS = ("peppa_tpu_torch::mha_attention",)  # calls kept with shapes
SHORT_GAP_S = 50e-6  # shorter idle gaps are summed, not named


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window of `seconds`, the device synchronised at its
    ends; traced, its second half under the profiler (module doc).  A
    driver calls `running()` before each step or request, and tags it with
    `traced` as it stands after the call."""

    def __init__(self, device, seconds: float, traced: bool):
        self.device = device
        self.length = seconds
        self.want_trace = traced
        self.prof = None
        self.t0 = self.t_split = self.t_trace = self.t1 = None

    @property
    def traced(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        sync(self.device)
        self.t0 = time.perf_counter()

    def running(self) -> bool:
        elapsed = time.perf_counter() - self.t0
        if (self.want_trace and self.prof is None
                and elapsed >= self.length / 2):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.t_split = time.perf_counter()
            self.prof = torch.profiler.profile(activities=acts,
                                               record_shapes=True)
            self.prof.__enter__()
            sync(self.device)
            self.t_trace = time.perf_counter()
        return elapsed < self.length

    def stop(self) -> None:
        sync(self.device)
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    @property
    def seconds(self) -> float:
        """The untraced part: the whole window of an untraced run."""
        return (self.t_split or self.t1) - self.t0

    @property
    def traced_seconds(self) -> float:
        """From the profiler's start to the window's end."""
        return self.t1 - self.t_trace if self.t_trace else 0.0

    def reduce(self) -> Optional[Dict[str, object]]:
        if self.prof is None:
            return None
        out = reduce_trace(self.prof, self.traced_seconds)
        self.prof = None
        return out


def merged(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
           ) -> List[Tuple[float, float]]:
    """The union of `intervals` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_length(intervals: Sequence[Tuple[float, float]],
                 lo: float, hi: float) -> Tuple[float, List[Tuple[float,
                                                                 float]]]:
    """(length of the union of `intervals` clipped to [lo, hi], the gaps
    inside [lo, hi] that the union leaves)."""
    union = merged(intervals, lo, hi)
    edges = [lo] + [x for iv in union for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return sum(e - s for s, e in union), gaps


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
            ) -> float:
    """The length two sorted disjoint interval lists share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(spans: List[Tuple[float, float, str]], t: float
               ) -> Optional[str]:
    """The name of the shortest span of `spans` (sorted by start) open at
    `t`, among the 256 that began last before it."""
    best = None
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    for s, e, name in reversed(spans[max(0, i - 256):i]):
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def reduce_trace(prof, window_s: float) -> Dict[str, object]:
    """The numbers of one traced window (module doc), from the profiler's
    raw events.  Times in seconds; the window runs from the first event
    for the host-clock length `window_s`."""
    cuda = torch.autograd.DeviceType.CUDA
    device, ranges, ops, calls = [], [], [], {}
    for evt in prof.profiler.kineto_results.events():
        s = evt.start_ns() * 1e-9
        e = s + evt.duration_ns() * 1e-9
        name = evt.name()
        if evt.device_type() == cuda:
            if not evt.is_user_annotation():
                device.append((s, e, name, evt.linked_correlation_id()))
        elif name in RANGES:
            ranges.append((s, e, name))
        else:
            ops.append((s, e, name))
            if name in OPERATORS:
                calls[evt.correlation_id()] = {
                    "name": name,
                    "shapes": [list(x) for x in evt.shapes()],
                    "dtypes": list(evt.dtypes()), "device_s": 0.0}
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name, link in device:
        by_op[name] += e - s
        if link in calls:
            calls[link]["device_s"] += e - s
    starts = [x[0] for x in device] + [x[0] for x in ranges + ops]
    lo = min(starts) if starts else 0.0
    hi = lo + window_s
    busy, gaps = union_length([(s, e) for s, e, _, _ in device], lo, hi)
    in_ranges = merged([(s, e) for s, e, _ in ranges], lo, hi)
    ranges.sort()
    ops.sort()
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e - s < SHORT_GAP_S:
            idle[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += e - s
            continue
        where = _innermost(ranges, s) or "outside the ranges"
        what = _innermost(ops, s)
        idle[where if what is None else f"{where} > {what}"] += e - s
    return {
        "window_s": window_s, "busy_s": busy,
        "ranges_s": sum(e - s for s, e in in_ranges),
        "ranges_busy_s": overlap(merged([(s, e) for s, e, _, _ in device],
                                        lo, hi), in_ranges),
        "device_ops": sorted(by_op.items(), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:10],
        "calls": list(calls.values()), "device_events": len(device),
    }


def idle_share(run, within_ranges: bool = False) -> Optional[float]:
    """100 (1 - busy / window) of a traced run, None untraced; with
    `within_ranges`, of the time the host spent inside the benchmark's
    ranges (a served request's calls)."""
    trace = run.get("trace")
    if not trace:
        return None
    busy, span = ((trace["ranges_busy_s"], trace["ranges_s"])
                  if within_ranges else (trace["busy_s"], trace["window_s"]))
    return 100.0 * (1.0 - busy / span) if span > 0 else None
