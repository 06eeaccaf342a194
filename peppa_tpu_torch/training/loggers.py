"""Metric logging: metrics.csv in the run directory, and TensorBoard event
files where `tensorboardX` is installed.

Mirrors peppa_tpu/training/loggers.py, column for column.  Each `log()`
appends one row; the file is rewritten only when a row brings a metric
name the header lacks (a few times a run), by re-reading the rows on disk.
On resume into an existing run directory the header is adopted, so a
resumed run extends the same file.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional


class MetricsLogger:
    def __init__(self, version_dir: str):
        self.version_dir = version_dir
        os.makedirs(version_dir, exist_ok=True)
        self._csv_path = os.path.join(version_dir, "metrics.csv")
        self._fields: List[str] = ["step", "epoch", "time"]
        self._fh = None  # append handle, opened lazily
        if os.path.exists(self._csv_path):
            # resume: adopt the existing header so appended rows line up
            try:
                with open(self._csv_path, newline="") as f:
                    header = next(csv.reader(f), None)
                if header:
                    self._fields = list(header)
                    for base in ("step", "epoch", "time"):
                        if base not in self._fields:
                            self._fields.append(base)
                            self._rewrite_with_fields(self._fields)
            except (OSError, csv.Error):
                pass
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(logdir=version_dir)

    def log(self, metrics: Dict[str, float], step: int,
            epoch: Optional[int] = None) -> None:
        row = {"step": step, "epoch": epoch, "time": time.time()}
        new_fields = []
        for k, v in metrics.items():
            row[k] = float(v)
            if k not in self._fields:
                new_fields.append(k)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), global_step=step)
        if new_fields:
            self._rewrite_with_fields(self._fields + new_fields)
        self._append(row)

    def _append(self, row: Dict) -> None:
        if self._fh is None:
            exists = os.path.exists(self._csv_path)
            self._fh = open(self._csv_path, "a", newline="")
            if not exists or os.path.getsize(self._csv_path) == 0:
                csv.DictWriter(self._fh, fieldnames=self._fields).writeheader()
        csv.DictWriter(self._fh, fieldnames=self._fields).writerow(row)
        self._fh.flush()

    def _rewrite_with_fields(self, fields: List[str]) -> None:
        """Expand the header: re-read rows on disk, rewrite once, reopen."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        old_rows: List[Dict] = []
        if os.path.exists(self._csv_path):
            try:
                with open(self._csv_path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
            except (OSError, csv.Error):
                old_rows = []
        tmp = self._csv_path + ".tmp"
        with open(tmp, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            for r in old_rows:
                writer.writerow({k: v for k, v in r.items() if k in fields})
        os.replace(tmp, self._csv_path)
        self._fields = list(fields)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
