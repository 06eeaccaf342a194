"""The acceptance gate of a long training run: `python -m
peppa_tpu_torch.soak_report run_dir [run_dir ...]`.

The port's counterpart of scripts/soak_report.py, with the same checks,
printed lines and exit codes, over the run directories the port's trainer
writes (hparams.yaml, metrics.csv, checkpoints/*.ckpt with their .ckpt.json
sidecars) or the JAX package's:

  - LR-schedule parity: every logged lr equals the configured BertAdam
    schedule at that row's optimizer step (`training/loop.py` logs
    `schedule_fn(...)(micro_step // accum)`), here the port's own
    `training/optimization.py::schedule_fn`;
  - loss health: all train losses finite, smoothed start and end;
  - throughput: mean and last items_per_sec;
  - the validation history: every row carrying val metrics;
  - the checkpoint audit: both monitors and last.ckpt present, each
    monitor's best_model_score equal to the max of its metrics.csv column.

Several run directories are a resume chain in order (a `--resume_from` or
`--auto_resume` continuation logs into a fresh version directory): the
rows an earlier run logged at or past its successor's first step are
superseded and dropped.  The exit code is 1 if any check fails, else 0.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import math
import os
import sys
from typing import List, Optional

import yaml

from peppa_tpu_torch.training.optimization import schedule_fn

MONITORS = ("valnarr_rec_fixed", "valnarr_triplet")


def _fval(row: dict, key: str) -> Optional[float]:
    v = row.get(key, "")
    return float(v) if v not in ("", None) else None


def _chain_rows(run_dirs: List[str]):
    """(rows of the chain, wall seconds): each run's rows before its
    successor's first step."""
    per_dir = []
    for d in run_dirs:
        with open(os.path.join(d, "metrics.csv")) as f:
            per_dir.append(list(csv.DictReader(f)))
    rows, wall = [], 0.0
    for i, dir_rows in enumerate(per_dir):
        if not dir_rows:
            continue
        cutoff = None
        if i + 1 < len(per_dir) and per_dir[i + 1]:
            cutoff = int(per_dir[i + 1][0]["step"])
        kept = [r for r in dir_rows
                if cutoff is None or int(r["step"]) < cutoff]
        if kept:
            wall += float(kept[-1]["time"]) - float(dir_rows[0]["time"])
            rows.extend(kept)
    return rows, wall


def _best_checkpoints(run_dirs: List[str]) -> tuple:
    """(whether a last.ckpt exists, monitor -> (file name, sidecar) of the
    best checkpoint over the whole chain: the best one may sit in an
    earlier run's directory when the resumed run never beat it)."""
    names, metas = [], {}
    for d in run_dirs:
        for p in sorted(glob.glob(os.path.join(d, "checkpoints", "*.ckpt"))):
            names.append(os.path.basename(p))
            side = p + ".json"
            metas[os.path.basename(p)] = (json.load(open(side))
                                          if os.path.exists(side) else {})
    monitored = {}
    for name, m in metas.items():
        mon = m.get("monitor")
        if not mon:
            continue
        prev = monitored.get(mon)
        if prev is None or (m.get("best_model_score") or -1e30) > \
                (prev[1].get("best_model_score") or -1e30):
            monitored[mon] = (name, m)
    return "last.ckpt" in names, monitored


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dirs", nargs="*",
                    default=["lightning_logs/version_0"],
                    help="run dir, or a resume chain of run dirs in order")
    rds = ap.parse_args(argv).run_dirs
    failures: List[str] = []

    def check(ok: bool, msg: str) -> None:
        print(f"- [{'PASS' if ok else 'FAIL'}] {msg}")
        if not ok:
            failures.append(msg)

    # the hyperparameters come from the live end of the chain
    with open(os.path.join(rds[-1], "hparams.yaml")) as f:
        hp = yaml.safe_load(f)
    opt = hp["optimizer"]
    accum = max(int(hp["training"]["trainer_args"].get(
        "accumulate_grad_batches", 1)), 1)

    rows, wall = _chain_rows(rds)
    if not rows:
        print("metrics.csv is empty")
        return 1
    train = [(int(r["step"]), _fval(r, "train_loss"), _fval(r, "lr"),
              _fval(r, "perf/items_per_sec"))
             for r in rows if _fval(r, "train_loss") is not None]
    val_cols = sorted({k for r in rows for k, v in r.items()
                       if k.startswith("val") and v not in ("", None)})
    vals = [r for r in rows
            if any(r.get(c) not in ("", None) for c in val_cols)]

    last_step = int(rows[-1]["step"])
    print(f"# Soak report: {' -> '.join(rds)}\n")
    if not train:
        # killed during sanity validation: rows, none with a train_loss
        check(False, "metrics.csv has rows but no train_loss values")
        print(f"\nFAILED: {len(failures)} failed check(s)")
        return 1
    print(f"- micro-steps logged: {train[0][0]}..{last_step} "
          f"(optimizer steps ≈ {last_step // accum}, accum={accum})")
    print(f"- wall: {wall / 3600:.2f} h over {len(rows)} logged rows"
          + (f" across {len(rds)} resume-chain runs" if len(rds) > 1 else ""))
    ips = [t[3] for t in train if t[3] is not None]
    if ips:
        print(f"- throughput: mean {sum(ips) / len(ips):.1f} / "
              f"last {ips[-1]:.1f} clips/s")
    k = max(1, min(5, len(train) // 2))
    head = sum(t[1] for t in train[:k]) / k
    tail = sum(t[1] for t in train[-k:]) / k
    print(f"- train_loss: first≈{head:.4f} → last≈{tail:.4f} "
          f"(min {min(t[1] for t in train):.4f})\n")

    print("## Checks\n")
    check(all(math.isfinite(t[1]) for t in train),
          f"all {len(train)} logged train losses finite")

    lr_at = schedule_fn(opt["schedule"], opt["lr"], opt["warmup"],
                        opt["t_total"])
    lr_err = 0.0
    for step, _, lr, _ in train:
        if lr is not None:
            lr_err = max(lr_err, abs(lr - float(lr_at(step // accum))))
    # a run of the JAX package logs the lr in float32: allow its rounding
    check(lr_err < 1e-5 * max(opt["lr"], 1e-12) + 1e-12,
          f"lr column matches {opt['schedule']}(lr={opt['lr']}, "
          f"warmup={opt['warmup']}, t_total={opt['t_total']}) "
          f"at step//accum (max err {lr_err:.2e})")

    have_last, monitored = _best_checkpoints(rds)
    check(have_last or not vals,
          "last.ckpt present" if have_last else
          "last.ckpt absent (ok only if no validation ran yet)")
    for mon in MONITORS:
        if mon not in monitored:
            check(not vals, f"monitor {mon}: no best checkpoint "
                            f"(ok only if no validation ran yet)")
            continue
        name, m = monitored[mon]
        best = m.get("best_model_score")
        col = [_fval(r, mon) for r in vals if _fval(r, mon) is not None]
        if best is None:
            check(False, f"monitor {mon}: sidecar {name}.json has "
                         f"best_model_score null")
        elif col:
            check(abs(best - max(col)) < 1e-6,
                  f"monitor {mon}: best_model_score {best:.4f} == "
                  f"max(metrics.csv)={max(col):.4f}  [{name}]")
        else:
            check(False, f"monitor {mon}: checkpoint exists but metrics.csv "
                         f"has no {mon} column")

    print("\n## Validation history\n")
    if vals:
        cols = ["step", "epoch"] + val_cols
        print("| " + " | ".join(cols) + " |")
        print("|" + "---|" * len(cols))
        for r in vals:
            cells = [r["step"], r["epoch"]] + [
                (f"{_fval(r, c):.4f}" if _fval(r, c) is not None else "")
                for c in val_cols]
            print("| " + " | ".join(str(c) for c in cells) + " |")
    else:
        print("(no validation rows yet)")

    print(f"\n{'OK' if not failures else 'FAILED'}: "
          f"{len(failures)} failed check(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
