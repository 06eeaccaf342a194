"""Run one cell of `BENCHMARK.json` once on the card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix,
metric readers and limits are found by name (`benchmark/cells.py`); the
driver of the mix's kind (`benchmark/kinds/`) builds the program
(`peppa_tpu_torch`) on weights drawn from the seed, warms the cell's shapes,
measures for `--seconds` and checks the window's outputs against the plain
reference.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number that decides `correct` beside
its limit; the same numbers close standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; so it does if the process holds a module
of JAX or of the JAX package after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from here: before torch is imported

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "peppa_tpu", "bench")
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".bench_cache")  # fixed, inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(CACHE, _sub))


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, flax's, the JAX
    package's or the root `bench` script's (whole names compared)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(device) -> Dict[str, object]:
    import subprocess

    import torch

    name = torch.cuda.get_device_name(device)
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        limit = float(out.stdout.splitlines()[device.index or 0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"name": name, "power_limit_w": limit}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, root=None, t0: Optional[float] = None,
             limits: Optional[Dict[str, float]] = None,
             hp_override: Optional[dict] = None) -> dict:
    """The cell's run record, with its `metrics` read.  `limits` and
    `hp_override` (groups merged into the configuration's hparams: the
    int8 control) serve the calibration and the tests."""
    import torch

    from benchmark.cells import ROOT, Bench

    bench = Bench(root or ROOT)
    cell = bench.workload(workload)
    hp = json.loads(json.dumps(bench.config(cell["config"])["hparams"]))
    for group, values in (hp_override or {}).items():
        hp.setdefault(group, {}).update(values)
    traffic = bench.traffic(cell["traffic"])
    ctx = {"workload": workload, "hp": hp, "traffic": traffic,
           "seed": int(seed), "seconds": float(seconds), "traced": traced,
           "device": torch.device(device), "t0": T0 if t0 is None else t0,
           "limits": bench.limits(workload) if limits is None else limits}
    driver = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    ctx["marks"] = [("imported", time.perf_counter())]
    record = driver.run(ctx)
    record["marks"] = {k: t - ctx["t0"] for k, t in ctx["marks"]}
    record.update(workload=workload, hp=hp, traffic=traffic,
                  seed=int(seed))
    record["correct"] = (all(c["value"] <= c["limit"]
                             for c in record["checks"].values())
                         and record["attempted"] > 0)
    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    record["metrics"] = metrics
    return record


def result_line(record: dict, device_info: dict, count: int) -> dict:
    device = {"platform": "gpu", "kind": device_info["name"],
              "count": count,
              "memory_peak_bytes": record["memory_peak_bytes"],
              "power_limit_w": device_info["power_limit_w"]}
    line = {"correct": bool(record["correct"]),
            "attempted": int(record["attempted"]),
            "failed": int(record["failed"]),
            "metrics": record["metrics"], "device": device}
    trace = record.get("trace")
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace["device_ops"]],
            "idle_gaps": [[n, s] for n, s in trace["idle_gaps"]]}
    line["checks"] = record["checks"]
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.cells import Bench

    chips = int(Bench().workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    record = run_cell(args.workload, args.seed % 2 ** 63, args.seconds,
                      bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}", file=sys.stderr)
        return 2
    line = result_line(record, card_info(device), chips)
    print("benchmark: " + " ".join(
        f"{k} {record[k]!r}" for k in ("setup_s", "window_s", "trace_s",
                                       "reference_s", "memory_peak_bytes",
                                       "alloc_retries", "marks")
        if k in record), file=sys.stderr)
    for name, c in record["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
