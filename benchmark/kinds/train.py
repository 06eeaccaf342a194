"""The `train` driver: `training.step.train_step` over one `TrainState`.

Set-up builds the state on the drawn weights and drives it from the seed
through the first CHECKED_GROUPS accumulation groups (k micro-steps each,
the first ones taking every bucket shape once, each group closed by a
BertAdam step), through the window's own feed and call.  The window goes
on with the same object.  The check, after the window, runs the reference
over those groups and compares each micro-step's loss; per trained
tensor, the norm of the first gradient BertAdam took (its first moment
after one step, over 1 - b1); and per trained tensor, the norm of the
parameters' change over both steps.  The schedule's rate is 0 at the
first step and lr * warmup_linear(1 / t_total) at the second, on both
sides, so the second step is the first that moves the parameters.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import generate, kinds
from benchmark.program import build_model, port_config
from benchmark.reference import model as ref
from benchmark.reference import train as rtrain
from benchmark.trace import Window
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.training.step import train_step

CHECKED_GROUPS = 2


def clip_batch(b: dict) -> ClipBatch:
    return ClipBatch(video=b["video"], audio=b["audio"],
                     video_duration=b["durations"],
                     audio_duration=b["durations"],
                     video_frames=b["video_frames"],
                     audio_samples=b["audio_samples"])


def optimizer_grad_norms(state: TrainState, b1: float):
    """{name: norm of the gradient BertAdam took}: its first moment after
    one step over (1 - b1); 0 where it holds none."""
    names, norms = [], []
    for name, p in state.params.items():
        st = state.optimizer.state.get(p, {})
        names.append(name)
        norms.append(torch.linalg.vector_norm(st["m"].double()) / (1 - b1)
                     if "m" in st else torch.zeros((), dtype=torch.float64,
                                                   device=p.device))
    return dict(zip(names, torch.stack(norms).tolist()))


def param_change_norms(state: TrainState, start) -> dict:
    """{name: norm of the trained tensor's change from `start`}."""
    with torch.no_grad():
        norms = [torch.linalg.vector_norm((p - start[n]).double())
                 for n, p in state.params.items()]
    return dict(zip(state.params, torch.stack(norms).tolist()))


def run(ctx: dict) -> dict:
    hp, traffic, seed, dev = ctx["hp"], ctx["traffic"], ctx["seed"], \
        ctx["device"]
    rows = int(hp["data"]["train"]["batch_size"])
    k = int(hp["training"]["trainer_args"]["accumulate_grad_batches"])
    plan = generate.train_buckets(traffic, seed)

    def feed(i, bucket):
        return generate.train_batch(traffic, hp, seed, i, bucket, rows, dev)

    weights = ref.draw_weights(hp, seed, dev)
    model = build_model(hp, weights, dev)
    ctx["marks"].append(("built", time.perf_counter()))
    del weights
    state = TrainState.create(model, port_config(hp))
    check_buckets, check_losses = [], []
    for i in range(CHECKED_GROUPS * k):
        bucket = next(plan)
        check_buckets.append(bucket)
        state, out = train_step(state, clip_batch(feed(i, bucket)), seed,
                                device=dev)
        check_losses.append(out["train_loss"])
        if i == k - 1:
            prog_g = optimizer_grad_norms(state, hp["optimizer"]["b1"])
    prog_losses = torch.stack(check_losses).tolist()
    prog_dp = param_change_norms(state, ref.draw_weights(hp, seed, dev))
    retries = kinds.alloc_retries(dev)
    win = Window(dev, ctx["seconds"], ctx["traced"])
    win.start()
    setup_s = win.t0 - ctx["t0"]
    steps, losses, events = [], [], []
    batch, i = None, CHECKED_GROUPS * k
    while win.running():
        bucket = next(plan)
        batch = clip_batch(feed(i, bucket))
        timed = ctx["traced"] and not win.traced and dev.type == "cuda"
        if timed:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        with record_function("train_step"):
            state, out = train_step(state, batch, seed, device=dev)
        if timed:
            events[-1][1].record()
        losses.append(out["train_loss"])
        steps.append({"bucket": bucket, "rows": rows, "traced": win.traced,
                      "opt": state.step % k == 0})
        i += 1
    win.stop()
    record = {"setup_s": setup_s, "window_s": win.seconds,
              "memory_peak_bytes": kinds.peak_bytes(dev),
              "attempted": len(steps), "steps": steps}
    if retries is not None:
        record["alloc_retries"] = kinds.alloc_retries(dev) - retries
    nonfinite = (int((~torch.isfinite(torch.stack(losses))).sum())
                 if losses else 0)
    record["failed"] = nonfinite
    for step, (e0, e1) in zip(steps, events):
        step["ms"] = e0.elapsed_time(e1)
    t = time.perf_counter()
    record["trace"] = win.reduce()
    record["trace_s"] = time.perf_counter() - t
    del state, model, out, batch, losses, check_losses
    kinds.release(dev)
    t_ref = time.perf_counter()

    batches = [feed(j, b) for j, b in enumerate(check_buckets)]
    refr = rtrain.optimizer_steps(hp, ref.draw_weights(hp, seed, dev),
                                  batches, seed, ref.Ops(), CHECKED_GROUPS)
    readings = rtrain.readings(prog_losses, prog_g, prog_dp, refr)
    for key in ("worst_leaves", "worst_changes", "unmoved_leaves"):
        record[key] = readings.pop(key)
    readings["nonfinite_losses"] = nonfinite
    record["readings"] = readings
    record["reference_s"] = time.perf_counter() - t_ref
    record["checks"] = kinds.checks(readings, ctx["limits"])
    return record


def opt_rows(steps):
    """Per bucket, (the micro-steps that carry an optimizer step, those
    that do not)."""
    by = {}
    for s in steps:
        if "ms" in s and not s["traced"]:
            by.setdefault(s["bucket"], ([], []))[0 if s["opt"] else 1].append(
                s["ms"])
    return by


def opt_step_extra_ms(steps):
    """Within each bucket the mean micro-step with a BertAdam step minus
    the mean without, weighted by the bucket's share of those micro-steps;
    None where no bucket has both."""
    total, weight = 0.0, 0
    for with_opt, without in opt_rows(steps).values():
        if with_opt and without:
            n = len(with_opt) + len(without)
            total += n * (np.mean(with_opt) - np.mean(without))
            weight += n
    return total / weight if weight else None
