"""The port's tracing: spans, counters, profiler traces and throughput.

Spans.  `span(name)` marks a phase of the program (`train.forward`,
`serve.h2d`, `model.video`, ...; PERF.md lists them).  While no span is
recorded it returns one shared no-op context (a flag read and the
profiler's flag read: no allocation, event or range), so the hot path
keeps its spans.  A span is recorded:

- while `recording()` is on: its name, its host start and end on
  `time.time_ns()` (the clock `torch.profiler` stamps its events with), its
  id, its parent's and its root's (the spans of one micro-step or request
  share the root's id), kept in a bounded buffer that `drain()` empties;
  with no profiler active and CUDA initialised, also a pair of pooled
  timing events on the current stream, resolved to the device time between
  them only by `drain()`, never on the hot path;
- while a `torch.profiler` is active: as a `record_function(name)` range,
  in the Chrome trace and among the host operations the benchmark names
  the card's idle gaps by; no CUDA events then (the profiler holds the
  device's own timeline).

Under `torch.compile` a span is the no-op.

Counters.  `count(name, n)` adds to one process-wide registry (always on:
an add under a lock, since the aligner's threads launch kernels at once);
`counters()` is a snapshot.  The kernels count their launches
(`mha_attention.launches`, `mha_attention_bwd.launches`,
`fused_triplet_loss.launches`), the int8 products their calls
(`int8_conv.calls`, `int8_matmul.calls`), the data layer its batches
(`NativeBatchLoader.served`, `Prefetcher.side_stream_copies`) and the
service its rows (`serve.rows_real.*`, `serve.rows_run.*`).

`trace(dir)` records a `torch.profiler` trace (host and CUDA activities)
of the wrapped region into `dir` as a Chrome trace JSON, which Perfetto
and chrome://tracing open; the spans opened inside it are its ranges.
`StepTimer` reads the host clock only and synchronises nothing: in the
trainer each step is timed where it has been issued, and the device holds
the host back where the loop reads a loss (the finiteness check, one step
late), as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16  # the buffer keeps the newest spans recorded

_on = False  # recording() (module doc)
_NOOP = contextlib.nullcontext()  # the span while none is recorded
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_events: List[torch.cuda.Event] = []  # timing events free for reuse
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open spans
_counts: Dict[str, int] = {}
_count_lock = threading.Lock()


def _event() -> torch.cuda.Event:
    try:
        return _events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "_range", "_marks", "_kept")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self._range = self._marks = None

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self._kept = _on
        self.start_ns = time.time_ns()
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        elif _on and torch.cuda.is_initialized():
            self._marks = (_event(), _event())
            self._marks[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        elif self._marks is not None:
            self._marks[1].record()
        self.end_ns = time.time_ns()
        _local.stack.pop()
        if self._kept:
            _spans.append(self)
        return False


def span(name: str):
    """A context marking the phase `name` (module doc): the shared no-op
    unless spans are recorded or a profiler is active."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    if torch.compiler.is_compiling():
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans are kept for the wrapped block."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def drain() -> List[dict]:
    """The kept spans, oldest start first, and an empty buffer: each a
    dict of `name`, `id`, `parent` (None for a root), `root`, `start_ns`,
    `end_ns` (host, `time.time_ns()`) and `device_ms` (the device time
    between its events on its stream; None without them).  Waits for each
    span's end event, so the caller need not synchronise first."""
    out = []
    while _spans:
        s = _spans.popleft()
        device_ms = None
        if s._marks is not None:
            s._marks[1].synchronize()
            device_ms = s._marks[0].elapsed_time(s._marks[1])
            _events.extend(s._marks)
            s._marks = None
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "root": s.root, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "device_ms": device_ms})
    out.sort(key=lambda d: (d["start_ns"], d["id"]))
    return out


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process-wide counter `name`."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter (0 for a name never counted)."""
    with _count_lock:
        return collections.Counter(_counts)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A `torch.profiler` trace of the wrapped region, written to
    `log_dir`/trace_<pid>_<ns>.json (the directory is made); CUDA
    activity too when the card is there, and the spans opened inside as
    ranges.  A no-op when `log_dir` is None or empty.  The caller
    synchronises before the region ends if the trace should hold all the
    device work it issued."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Steps/s and items/s after `warmup_steps` steps (the first steps
    build kernels and pick algorithms).  The clock starts at step
    warmup_steps + 1; the window holds the steps after it, and so do the
    items counted."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._items = 0
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    def step(self, items: int = 0) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._count == self.warmup_steps + 1:
            self._t0 = now
        elif self._count > self.warmup_steps + 1:
            self._items += items
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return (self._count - self.warmup_steps - 1) / (self._last - self._t0)

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return self._items / (self._last - self._t0)

    def metrics(self, prefix: str = "perf/") -> Dict[str, float]:
        return {f"{prefix}steps_per_sec": self.steps_per_sec,
                f"{prefix}items_per_sec": self.items_per_sec}


def host_rss_bytes() -> int:
    """Resident set size of this process, in bytes (0 if unreadable)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
