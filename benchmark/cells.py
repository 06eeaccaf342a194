"""Finds a cell's pieces by the names in `BENCHMARK.json`.

Under the root of a checkout (`root`):

- `BENCHMARK.json`: the cells, the metrics and their bounds;
- `benchmark/configs/<config>.json`: a configuration, its `hparams` as the
  program reads them (the repository's YAML layout), `source`, `reduced`
  and `assumed`;
- `benchmark/traffic/<traffic>.json`: a traffic mix, the parameters that
  the generator of its `kind` (`train`, `serve`, `encode`) reads;
- `benchmark/metrics/<metric>.py`: a metric's reader, `read(run) ->
  float or None` over the run's record (`benchmark/run.py`);
- `benchmark/limits/<workload>.json`: the limit of each number that
  decides the cell's `correct`, with the readings it was set from.

A new configuration, mix, metric or cell is new files and new entries:
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """`BENCHMARK.json` under `root` and the files its names point to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")
        self.dir = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict[str, float]:
        return {k: float(v["limit"]) for k, v in
                _json(self.dir / "limits" / f"{workload}.json").items()}

    def metrics(self, workload: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced): those whose `workloads` list it, or that have none."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark.metrics." + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
