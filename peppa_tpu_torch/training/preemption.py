"""Preemption handling for scheduled training.

Mirrors peppa_tpu/training/preemption.py.  The trainer arms a
`PreemptionGuard` around `fit`: on SIGTERM or SIGUSR1 (`tpu.preempt_signals`)
the handler only sets a flag; the loop sees it at the next step boundary,
writes `checkpoints/preempted.ckpt` and returns, and the CLI exits 75 so
that the scheduler requeues the job, which resumes with `--resume_from` or
`--auto_resume`.  Off the main thread no handler can be installed and the
guard never triggers.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Sequence


class PreemptionGuard:
    """Context manager: arm signal handlers, expose a `triggered` flag.

    The handler is async-signal-safe by doing nothing but setting an event;
    all checkpointing happens on the training thread at a step boundary,
    where the model state is consistent.  Previous handlers are restored on
    exit so nested/sequential trainers behave.
    """

    def __init__(self, signals: Sequence[str] = ("SIGTERM", "SIGUSR1")):
        self._names = list(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self.signame: Optional[str] = None

    def __enter__(self) -> "PreemptionGuard":
        for name in self._names:
            signum = getattr(signal, name, None)
            if signum is None:
                logging.warning("preemption: unknown signal %r ignored", name)
                continue
            try:
                self._prev[signum] = signal.signal(signum, self._handle)
            except ValueError:
                # not the main thread of the main interpreter
                logging.warning(
                    "preemption: cannot install %s handler off the main "
                    "thread; guard disabled", name)
                break
        return self

    def __exit__(self, *exc) -> bool:
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except ValueError:  # pragma: no cover - same thread constraint
                pass
        self._prev.clear()
        return False

    def _handle(self, signum, frame) -> None:
        if self.signame is None:  # record the FIRST triggering signal
            self.signame = signal.Signals(signum).name
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()
