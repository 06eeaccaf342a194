"""The readings that a cell's limits are set from, on the card, in one
process.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 8] [--out FILE]

- The program: one run of the cell per seed (`--seconds` of window), its
  check's readings.
- The control, the nearest precision below the configuration's bf16:
  serving and encoding cells run the program's own int8 path
  (`tpu.quantize_int8`, W8A8) in its place; training cells, which have no
  int8 training path, put the reference at int8 (`reference.model.Ops(
  quant=True)`) in the program's place over the check's micro-steps.
- Training cells also read the fault "half of the batch left out, the
  mean over the rest": the reference with the loss over the first half of
  each batch in the program's place.  The encoding cell reads the same
  fault in the program: its loss over the first half of each batch.

Each reading is one JSON line on standard output (and in `--out`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import generate, kinds
from benchmark.cells import Bench
from benchmark.kinds import encode as encode_driver
from benchmark.kinds.train import CHECKED_GROUPS
from benchmark.reference import model as ref
from benchmark.reference import train as rtrain
from benchmark.run import run_cell


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def train_control(bench: Bench, workload: str, seed: int, device) -> dict:
    """The int8 reference's and the half-batch reference's readings
    against the float32 reference over the checked accumulation groups."""
    cell = bench.workload(workload)
    hp = bench.config(cell["config"])["hparams"]
    traffic = bench.traffic(cell["traffic"])
    rows = int(hp["data"]["train"]["batch_size"])
    k = int(hp["training"]["trainer_args"]["accumulate_grad_batches"])
    plan = generate.train_plan(traffic, seed, CHECKED_GROUPS * k)
    batches = [generate.train_batch(traffic, hp, seed, i, b, rows, device)
               for i, b in enumerate(plan)]
    w = ref.draw_weights(hp, seed, device)
    base = rtrain.optimizer_steps(hp, w, batches, seed, ref.Ops(),
                                  CHECKED_GROUPS)
    out = {}
    for name, ops, part in (("control_int8", ref.Ops(quant=True),
                             slice(None)),
                            ("fault_half_batch", ref.Ops(),
                             slice(0, rows // 2))):
        other = rtrain.optimizer_steps(hp, w, batches, seed, ops,
                                       CHECKED_GROUPS, part)
        out[name] = rtrain.readings(other["losses"],
                                    rtrain.norms(other["g"]),
                                    rtrain.norms(other["dp"]), base)
        for key in ("worst_leaves", "worst_changes"):
            out[name][key] = out[name][key][:3]
        del other
        kinds.release(device)
    return out


@contextlib.contextmanager
def loss_over_half_batch():
    """The encoding driver's loss taken over the first half of each
    batch."""
    real = encode_driver.triplet_loss

    def half(v, a, margin=0.2):
        n = v.shape[0] // 2
        return real(v[:n], a[:n], margin=margin)
    encode_driver.triplet_loss = half
    try:
        yield
    finally:
        encode_driver.triplet_loss = real


def control_readings(bench: Bench, workload: str, seed: int, device,
                     seconds: float) -> dict:
    """{"control_int8": readings} (and for a training cell the fault's
    readings) of one seed."""
    kind = bench.traffic(bench.workload(workload)["traffic"])["kind"]
    if kind == "train":
        return train_control(bench, workload, seed, device)
    rec = run_cell(workload, seed, seconds, False, device,
                   root=bench.root, t0=time.perf_counter(),
                   hp_override={"tpu": {"quantize_int8": True}})
    out = {"control_int8": rec["readings"]}
    if kind == "encode":
        del rec
        kinds.release(device)
        with loss_over_half_batch():
            rec = run_cell(workload, seed, seconds, False, device,
                           root=bench.root, t0=time.perf_counter())
        out["fault_half_batch"] = rec["readings"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = Bench()
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    for seed in args.seeds:
        t = time.perf_counter()
        rec = run_cell(args.workload, seed, args.seconds, False, dev,
                       t0=time.perf_counter())
        emit({"workload": args.workload, "side": "program", "seed": seed,
              "readings": rec["readings"], "attempted": rec["attempted"],
              "worst_leaves": rec.get("worst_leaves"),
              "worst_changes": rec.get("worst_changes"),
              "unmoved_leaves": rec.get("unmoved_leaves"),
              "memory_peak_bytes": rec["memory_peak_bytes"],
              "setup_s": rec["setup_s"],
              "reference_s": rec.get("reference_s"),
              "seconds": time.perf_counter() - t})
        del rec
        kinds.release(dev)
    for seed in args.control_seeds:
        t = time.perf_counter()
        readings = control_readings(bench, args.workload, seed, dev,
                                    args.seconds)
        kinds.release(dev)
        emit({"workload": args.workload, "side": "control", "seed": seed,
              "readings": readings, "seconds": time.perf_counter() - t})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
