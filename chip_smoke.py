#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`peppa_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # one card, no arguments

Phases:
  1. the card's name and power limit; build the CUDA kernels from
     `peppa_tpu_torch/csrc/` (seconds printed);
  2. the registers and spill bytes (`ptxas -v`) of the bf16 attention
     kernels (forward, backward dq and dkdv) and the loss kernels; each
     kernel against its plain PyTorch version on the card, at the main
     paths' shapes, with its time, the plain version's and a library
     yardstick's: the attention forward (serving shapes, T=316 and 826),
     the attention backward (training shapes, T=316 and 826; it and SDPA's
     backward as the median of 7 timings, with their spread), the triplet
     loss alone and with its gradient (B = 8, 13, 32, 1024 and two
     mixed-activity cases; timed at B = 8 and 32 back-to-back and replayed
     from a CUDA graph, with `torch.profiler`'s kernel times beside);
  3. the serving/eval forward of the base configuration (`hparams_base.yaml`:
     wav2vec2-base + R(2+1)D-18, bf16) at full width from seeded random
     weights: `EncoderService` warm-up and mixed-length requests over every
     bucket, then `eval_step` on a B=32 2.3 s batch; then the encode time
     of both towers at B=32 on the 2.3 s bucket and of the audio tower
     alone on the 6.0 s bucket (T=826);
  4. the training step of the same configuration at full width and depth,
     bf16, micro-batch 8 of 2.3 s clips, `accumulate_grad_batches` 8, for 2
     optimizer steps (16 micro-steps), twice: (a) `audio.dropout: 0.0`,
     every attention through the forward and backward kernels; (b) the
     defaults (dropout 0.1, layer-drop 0.05), attention on the JAX
     package's own plain route, and the first micro-steps run again from
     the same seed to show the run is reproducible; each timed as the
     host-clock mean over micro-steps 2-16 and as the median of their
     CUDA-event times;
 4c. `Trainer.fit` of the same configuration (the defaults: dropout,
     layer-drop) on `SyntheticPigData` (128 training clips, 100 in each of
     the four validation sets): sanity validation of 2 batches a loader,
     16 micro-steps (2 optimizer steps), the full validation (500
     bootstrap subsets), the dual-monitor and last checkpoints (one file,
     hard-linked); the launches of the attention forward kernel (12 per
     audio batch encoded) and the loss kernel (one per eval batch and per
     micro-step), and no plain version on the card; last.ckpt equal to the
     trained state; `EncoderService.from_checkpoint` embedding a 2.3 s
     pair as the trained model does; a resume from last.ckpt for 8
     micro-steps, the loaded state equal to the file; then each kernel
     against its plain version on the inputs the two fits gave it, the
     first of each shape (validation batches of 1, 2, 3 and 2.3 s clips
     at B = 1-8, the micro-step's loss with its gradient); train clips/s
     (`StepTimer`), validation seconds, checkpoint bytes and seconds (the
     host copy also again and as copies alone), peak memory;
 4d. the same fit over the data pipeline: an episode tree written to
     $TMPDIR at full size (180x100, 44.1 kHz; dialog train episodes 1-16,
     dialog val 197-209, narration val 1-13, two 12 s clips each), then
     `Trainer.fit` on `PigData` with the defaults (jittered windows, the
     native loader): the item caches and the pack built once (seconds and
     bytes), sanity validation, 16 micro-steps, the full validation (130
     clips in each fixed loader, 130 lines in each line loader), the
     checkpoints; `TripletScorer` on the dialog val lines with the trained
     model; the native batches served and the side-stream copies made
     during the fit, the launches of kernels 1 and 3, no plain version on
     the card; each kernel against its plain version at the path's shapes;
     then the native loader alone over one epoch's plan, the copy rate of
     one 2.3 s batch (pinned on a side stream, and pageable through
     `ClipBatch.to`), and the step alone on the fit's 16 batches;
  6. the evaluation entry (after 4d, on its episode tree): the base model
     (seeded, bf16) written as a run directory of each format under
     $TMPDIR (the port's `torch.save`, the JAX package's flax msgpack by
     the port's encoder, a reference Lightning file with no hparams.yaml)
     and read back by `load_best_model` on the card (write and load
     seconds, the weights equal to the source's, a 2.3 s B=8 batch
     embedded bit-identically); `python -m peppa_tpu_torch.evaluate` on
     the msgpack directory (the battery: triplet accuracy and recall@1-10
     of fixed and jittered windows, scrambled and not, 500 bootstrap
     subsets) and `python -m peppa_tpu_torch.targeted_eval --run` on 42
     minimal pairs cut from the tree's narration clips, each with its
     seconds, batches and kernel 1 launches (12 per batch; kernel 3 none;
     no plain version on the card); one B=8 video encode of the static,
     r3d_18 and mc3_18 towers, timed; then kernel 1 against its plain
     version at each path's first and longest shape;
  5. the same weights in float32 on the card (kernels) and on the CPU (plain
     versions): the serving embeddings of one 2.3 s pair, and one training
     micro-step (2 layers, B=2, `audio.dropout: 0.0`): loss and gradients;
  7. one JSON line of per-kernel numbers, one of the serving, training and
     evaluation metrics, the card's name and power limit, and the last line
     `{"ok": true, "device": {...}}`.

Launch counts are set to 0 just before each main path (3, 4a, 4b, the
fit and the resumed fit of 4c, the fit and the scorer of 4d, the loads,
the battery, the targeted path and the towers of 6) and read just after
it.

Any failed check raises, and the script exits non-zero.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): memory rate, dense bf16 tensor-core
# rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL_ATTN = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_pallas_kernels.py
# backward, elementwise |d| <= tol + tol * |plain|: float32 as the Pallas
# gradient test; bf16 outputs round to 8 bits (one ulp at |x| in [2, 4) is
# 1.6e-2)
TOL_ATTN_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
LOSS_GRAD_RTOL = 1e-4  # tests/test_pallas_kernels.py's loss gradients
EMB_TOL = 1e-4  # towers and embeddings, float32 (PARITY.md)
TRAIN_B, TRAIN_SECONDS, TRAIN_MICRO_STEPS = 8, 2.3, 16  # hparams_base.yaml


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn()` over `iters` back-to-back calls (CUDA
    events; inputs stay where the previous call left them, L2 included)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 10, replays: int = 20) -> float:
    """Device time of one `fn()`: `calls` calls captured once in a CUDA
    graph, replayed `replays` times between two CUDA events, so no host
    work sits between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def median_ms(fn, reps: int = 7):
    """(median, min, max) of `reps` `time_ms(fn)` readings: the spread of
    one kernel's time within a run."""
    import numpy as np

    times = [time_ms(fn) for _ in range(reps)]
    return float(np.median(times)), min(times), max(times)


def bound(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2
# the kernels whose registers and spills phase 2 prints: (source, pattern of
# the mangled entry name, label)
RESOURCE_KERNELS = (
    ("attention", r"(attention_(?:fwd|bwd_dq|bwd_dkdv)_bf16_kernel)"
                  r"ILi(\d+)ELb([01])E", "{0}<hd {1}, vec {2}>"),
    ("loss", r"(loss_cluster_kernel)ILi(\d)ELb([01])E", "{0}<R {1}, grad {2}>"),
    ("loss", r"(loss_tiles_kernel)ILb([01])E", "{0}<grad {1}>"),
    ("loss", r"(loss_(?:rows|grad)_kernel)", "{0}"),
)


def print_kernel_resources() -> None:
    """Registers and spill bytes of each bf16 attention kernel
    instantiation (forward, backward dq and dkdv; head dim, vector path) and
    of each loss kernel, from `ptxas -v` in this process's build."""
    from peppa_tpu_torch.ops.cuda import build

    for source in ("attention", "loss"):
        log = build.build_log.get(source)
        if log is None:
            print(f"{source} kernels: built by an earlier process, no ptxas "
                  "report here")
            continue
        name, spills = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name, spills = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            for src, pattern, label in RESOURCE_KERNELS:
                tag = re.search(pattern, name or "") if src == source else None
                if m and tag:
                    print(f"{label.format(*tag.groups())}: {m.group(1)} "
                          f"registers, spill stores {spills[0]} bytes, spill "
                          f"loads {spills[1]} bytes")
                    break


def check_attention(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                    mha_attention_plain)

    b, h, hd = 32, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    rows = []  # bf16 times at each T
    for t in (316, 826):
        ragged = torch.randint(1, t + 1, (b,), generator=gen, device="cuda",
                               dtype=torch.int32)
        ragged[0] = t
        ragged[1] = 1
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            q, k, v = (torch.randn(b, t, h, hd, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            for lengths in (None, ragged):
                got = mha_attention(q, k, v, lengths)
                want = mha_attention_plain(q, k, v, lengths)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tag = "ragged" if lengths is not None else "full"
                print(f"attention T={t} {name} {tag}: max|d|={err:.3g} "
                      f"(tol {TOL_ATTN[name]})")
                if not err <= TOL_ATTN[name]:
                    raise AssertionError(f"attention {name} T={t} {tag}: {err}")
                worst = max(worst, err) if name == "bfloat16" else worst
            # times at the main path's call: no lengths (serving pads)
            ms = time_ms(lambda: mha_attention(q, k, v))
            plain_ms = time_ms(lambda: mha_attention_plain(q, k, v), iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            elem = q.element_size()
            n_bytes = 4 * b * t * h * hd * elem
            flops = 4 * b * h * t * t * hd
            bms, by = bound(n_bytes, flops, name)
            print(f"attention T={t} {name}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} "
                  f"ms ({by})")
            if dtype == torch.bfloat16:
                rows.append({"T": t, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": bms,
                             "bound_by": by})
    # the kernel's line: T=316 (the 2.3 s bucket), with T=826 beside it
    report["attention"] = {**{k: v for k, v in rows[0].items() if k != "T"},
                           "max_abs_err": worst, "shapes": rows}


def check_attention_bwd(report: dict) -> None:
    import torch

    from peppa_tpu_torch.ops.cuda.attention import (_launch,
                                                    mha_attention_bwd,
                                                    mha_attention_bwd_plain)

    b, h, hd = TRAIN_B, 12, 64
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    rows = []  # bf16 times at each T
    for t in (316, 826):
        ragged = torch.randint(1, t + 1, (b,), generator=gen, device="cuda",
                               dtype=torch.int32)
        ragged[0] = t
        ragged[1] = 1
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            q, k, v, do = (torch.randn(b, t, h, hd, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            tol = TOL_ATTN_BWD[name]
            for lengths in (None, ragged):
                out, lse = _launch(q, k, v, lengths, scale, with_lse=True)
                got = mha_attention_bwd(q, k, v, do, lengths, scale, lse, out)
                want = mha_attention_bwd_plain(q, k, v, do, lengths, scale)
                torch.cuda.synchronize()
                tag = "ragged" if lengths is not None else "full"
                for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                    d = (g.float() - w.float()).abs()
                    err = d.max().item()
                    ok = bool((d <= tol + tol * w.float().abs()).all())
                    print(f"attention bwd T={t} {name} {tag} {gname}: "
                          f"max|d|={err:.3g} (tol {tol} + {tol}|plain|)")
                    if not ok:
                        raise AssertionError(
                            f"attention bwd {name} T={t} {tag} {gname}: {err}")
                    if name == "bfloat16":
                        worst = max(worst, err)
            # times at the training path's call: no lengths; the kernel and
            # SDPA's backward as medians of 7 timings (SDPA's spreads)
            out, lse = _launch(q, k, v, None, scale, with_lse=True)
            ms, lo, hi = median_ms(lambda: mha_attention_bwd(
                q, k, v, do, None, scale, lse, out))
            plain_ms = time_ms(lambda: mha_attention_bwd_plain(
                q, k, v, do, None, scale), iters=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2)
            lib_ms, lib_lo, lib_hi = median_ms(lambda: torch.autograd.grad(
                sdpa, (qt, kt, vt), dot, retain_graph=True))
            elem = q.element_size()
            n_bytes = 7 * b * t * h * hd * elem  # q, k, v, dO in; dQ, dK, dV
            flops = 10 * b * h * t * t * hd  # five products of T^2 hd
            bms, by = bound(n_bytes, flops, name)
            print(f"attention bwd T={t} {name}: kernel {ms:.4f} ms "
                  f"({lo:.4f}-{hi:.4f}), plain {plain_ms:.4f} ms, sdpa "
                  f"backward {lib_ms:.4f} ms ({lib_lo:.4f}-{lib_hi:.4f}), "
                  f"bound {bms:.4f} ms ({by})")
            if dtype == torch.bfloat16:
                rows.append({"T": t, "ms": ms, "ms_range": [lo, hi],
                             "plain_ms": plain_ms, "library_ms": lib_ms,
                             "library_ms_range": [lib_lo, lib_hi],
                             "bound_ms": bms, "bound_by": by})
            del sdpa
    report["attention_bwd"] = {
        **{k: v for k, v in rows[0].items() if k != "T"},
        "max_abs_err": worst, "shapes": rows}


def loss_times(b: int, d: int = 512) -> dict:
    """ms per call of the triplet loss at (b, d), as the eval step (the
    loss alone, no autograd) and a train micro-step (forward + gradient
    through autograd) call it: back-to-back (`time_ms`, host issue
    included) and replayed from a CUDA graph (`graph_ms`, device time)."""
    import torch

    from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss

    gen = torch.Generator(device="cuda").manual_seed(b)
    v = torch.randn(b, d, generator=gen, device="cuda")
    a = torch.randn(b, d, generator=gen, device="cuda")
    vg, ag = (x.clone().requires_grad_() for x in (v, a))

    def fwd():
        fused_triplet_loss(v, a, 0.2)

    def fwd_grad():
        torch.autograd.grad(fused_triplet_loss(vg, ag, 0.2), (vg, ag))

    return {"B": b, "fwd_ms": time_ms(fwd), "fwd_graph_ms": graph_ms(fwd),
            "fwd_grad_ms": time_ms(fwd_grad),
            "fwd_grad_graph_ms": graph_ms(fwd_grad)}


def _loss_cases():
    """(tag, v, a) on the card: random rows at B = 8, 13, 32, 1024 and
    hinges active in some pairs only (tests/torch_port_loss_data.py) at
    B = 8 and 100; D = 512."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_loss_data import mixed_activity

    gen = torch.Generator(device="cuda").manual_seed(1)
    for b in (8, 13, 32, 1024):
        yield (f"B={b} random",
               *(torch.randn(b, 512, generator=gen, device="cuda")
                 for _ in range(2)))
    for b in (8, 100):
        yield (f"B={b} mixed", *(torch.from_numpy(x).cuda()
                                 for x in mixed_activity(b, 512, seed=b)))


def check_loss(report: dict) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peppa_tpu_torch.ops.cuda.loss import (
        _launch, fused_triplet_loss, fused_triplet_loss_and_grad_plain,
        fused_triplet_loss_plain)

    worst = 0.0
    for tag, v, a in _loss_cases():
        b = v.shape[0]
        before = fused_triplet_loss.launches
        alone = fused_triplet_loss(v, a, 0.2)
        got = _launch(v, a, 0.2, grad=True)
        launches = fused_triplet_loss.launches - before
        want = fused_triplet_loss_and_grad_plain(v, a, 0.2)
        torch.cuda.synchronize()
        errs = [abs(alone.item() - want[0].item())] + [
            (g - w).abs().max().item() for g, w in zip(got, want)]
        print(f"loss {tag}: kernel {alone.item():.8f} plain "
              f"{want[0].item():.8f}; with the gradient: loss, dV, dA "
              f"max|d| {errs[1]:.3g}, {errs[2]:.3g}, {errs[3]:.3g}; "
              f"{launches} launches for the two calls")
        for loss in (alone, got[0]):
            torch.testing.assert_close(loss, want[0], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=LOSS_GRAD_RTOL,
                                       atol=LOSS_ATOL)
        if launches != 2:
            raise AssertionError(f"loss {tag}: {launches} launches for 2 calls")
        worst = max([worst] + errs)

    rows = []
    d = 512
    for b in (8, 32):
        gen = torch.Generator(device="cuda").manual_seed(b)
        v = torch.randn(b, d, generator=gen, device="cuda")
        a = torch.randn(b, d, generator=gen, device="cuda")
        row = loss_times(b, d)
        # the kernel alone with the gradient, as the train micro-step launches it
        row["grad_kernel_graph_ms"] = graph_ms(
            lambda: _launch(v, a, 0.2, grad=True))
        row["plain_ms"] = time_ms(lambda: fused_triplet_loss_plain(v, a, 0.2))
        row["plain_grad_ms"] = time_ms(
            lambda: fused_triplet_loss_and_grad_plain(v, a, 0.2))
        row["bound_ms"], row["bound_by"] = bound(2 * b * d * 4 + 4,
                                                 2 * b * b * d, "float32")
        row["grad_bound_ms"], row["grad_bound_by"] = bound(
            4 * b * d * 4 + 4, 6 * b * b * d, "float32")
        print(f"loss B={b}, D={d}: forward {row['fwd_ms']:.4f} ms "
              f"back-to-back, {row['fwd_graph_ms']:.4f} ms graph-replayed; "
              f"forward + gradient (autograd) {row['fwd_grad_ms']:.4f} / "
              f"{row['fwd_grad_graph_ms']:.4f} ms; the launch with the "
              f"gradient alone {row['grad_kernel_graph_ms']:.4f} ms "
              f"graph-replayed; plain {row['plain_ms']:.4f} / "
              f"{row['plain_grad_ms']:.4f} ms; bound {row['bound_ms']:.6f} / "
              f"{row['grad_bound_ms']:.6f} ms ({row['bound_by']} / "
              f"{row['grad_bound_by']})")
        # cross-check: the profiler's device time of each loss kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                _launch(v, a, 0.2, grad=False)
                _launch(v, a, 0.2, grad=True)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "loss_" in e.key and e.count:
                us = e.device_time_total / e.count
                print(f"loss B={b} profiler: {e.key[:60]} {us:.2f} us "
                      f"per launch ({e.count} launches)")
                row.setdefault("profiler_us", {})[e.key[:60]] = us
        rows.append(row)
    main = rows[1]  # B=32, the eval step's call
    report["triplet_loss"] = {
        "ms": main["fwd_ms"], "graph_ms": main["fwd_graph_ms"],
        "plain_ms": main["plain_ms"], "library_ms": None,
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "max_abs_err": worst, "shapes": rows}


# ------------------------------------------------------------------ phase 3
def _requests(rng, cfg, n: int):
    """`n` audio and `n` video requests of mixed durations over every
    bucket (0.5 s to 6.5 s: the longest crop to the last bucket)."""
    import numpy as np

    w, h = cfg.data.target_size
    durations = rng.uniform(0.5, 6.5, size=n)
    waves = [rng.normal(scale=0.1, size=int(d * cfg.data.audio_sample_rate))
             .astype(np.float32) for d in durations]
    clips = [rng.integers(0, 256, size=(max(1, int(d * 10)), h, w, 3),
                          dtype=np.uint8) for d in durations]
    return waves, clips


def _audio_batches(svc, waves) -> int:
    """Audio forwards the service runs for these requests."""
    from peppa_tpu_torch.utils.request_batching import group_by_bucket

    groups = group_by_bucket(waves, lambda x: svc._audio_bucket(x.shape[0]))
    return sum(-(-len(idxs) // svc.batch_size) for idxs in groups.values())


def _clip_batch(rng, cfg, b: int, seconds: float):
    import numpy as np

    from peppa_tpu_torch.data.types import ClipBatch

    w, h = cfg.data.target_size
    frames = int(round(seconds * 10))
    samples = int(round(seconds * cfg.data.audio_sample_rate))
    return ClipBatch(
        video=rng.integers(0, 256, size=(b, frames, h, w, 3), dtype=np.uint8),
        audio=rng.normal(scale=0.1, size=(b, samples)).astype(np.float32),
        video_duration=np.full((b,), seconds, np.float32),
        audio_duration=np.full((b,), seconds, np.float32),
        video_frames=rng.integers(frames // 2, frames + 1, size=b,
                                  dtype=np.int32),
        audio_samples=rng.integers(samples // 2, samples + 1, size=b,
                                   dtype=np.int32))


def _reset_counts() -> None:
    from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                    mha_attention_bwd)
    from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss

    mha_attention.launches = 0
    mha_attention_bwd.launches = 0
    fused_triplet_loss.launches = 0


def _counts() -> dict:
    from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                    mha_attention_bwd)
    from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss

    return {"attention_fwd": mha_attention.launches,
            "attention_bwd": mha_attention_bwd.launches,
            "triplet_loss": fused_triplet_loss.launches}


def run_slice(report: dict, card: str) -> None:
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.models.wav2vec2 import conv_output_length
    from peppa_tpu_torch.ops.loss import contrastive
    from peppa_tpu_torch.ops.similarity import cosine_matrix
    from peppa_tpu_torch.serving import EncoderService
    from peppa_tpu_torch.training.step import eval_step

    cfg = default_config()  # hparams_base.yaml: bf16, full width
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"base config: {n_params} parameters, "
          f"{cfg.training.precision}, init {time.perf_counter() - t0:.1f} s")
    svc = EncoderService(model, cfg, batch_size=32)
    rng = np.random.default_rng(0)
    waves, clips = _requests(rng, cfg, 40)
    batch = _clip_batch(rng, cfg, 32, 2.3)
    expected_audio = len(svc.buckets) + _audio_batches(svc, waves) + 1

    _reset_counts()
    t0 = time.perf_counter()
    svc.warmup()
    a = svc.embed_audio(waves)
    v = svc.embed_video(clips)
    sim = svc.similarity(v, a)
    ev, ea, loss = eval_step(model, batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    print(f"serving path: warmup + {len(waves)} audio + {len(clips)} video "
          f"requests + eval step in {elapsed:.1f} s; launches {launches}; "
          f"{expected_audio} audio forwards")

    n_layers = model.audio_encoder.wav2vec2.cfg.num_layers
    want = {"attention_fwd": n_layers * expected_audio, "attention_bwd": 0,
            "triplet_loss": 1}
    if launches != want:
        raise AssertionError(f"serving launches {launches} != {want}")
    for name, emb in (("audio", a), ("video", v)):
        norms = np.linalg.norm(emb, axis=1)
        if emb.shape != (40, 512) or not np.isfinite(emb).all() \
                or np.abs(norms - 1).max() > 1e-5:
            raise AssertionError(f"{name} embeddings: {emb.shape}, "
                                 f"norms {norms.min()}..{norms.max()}")
    if sim.shape != (40, 40) or not np.isfinite(sim).all():
        raise AssertionError(f"similarity {sim.shape}")
    plain = contrastive(cosine_matrix(ev, ea)).item()
    print(f"eval step: V {tuple(ev.shape)} A {tuple(ea.shape)} loss "
          f"{loss.item():.8f} (plain contrastive {plain:.8f})")
    if not (np.isfinite(loss.item())
            and abs(loss.item() - plain) <= 1e-5 * abs(plain)):
        raise AssertionError(f"eval loss {loss.item()} vs plain {plain}")
    report["launches"] = {"serve": launches}

    # encode throughput at B=32 on the 2.3 s bucket (host clock around
    # synchronised forwards; requests already on the device)
    audio = torch.from_numpy(batch.audio).cuda()
    video = torch.from_numpy(batch.video).cuda()
    times = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode_audio(audio)
            model.encode_video(video)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    step = float(np.median(times[1:]))
    report["encode_pairs_per_s"] = 32 / step
    print(f"encode: {step * 1e3:.2f} ms per B=32 2.3 s pair batch, "
          f"{32 / step:.1f} pairs/s ({card})")

    # the audio tower alone at B=32 on the last bucket (6.0 s), where the
    # attention forward weighs most (same clock and statistic)
    seconds = svc.buckets[-1]
    samples = int(round(seconds * cfg.data.audio_sample_rate))
    long_audio = torch.from_numpy(rng.normal(scale=0.1, size=(32, samples))
                                  .astype(np.float32)).cuda()
    times = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode_audio(long_audio)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    audio_ms = float(np.median(times[1:])) * 1e3
    report["audio_tower_ms_6s"] = audio_ms
    print(f"audio tower: {audio_ms:.2f} ms per B=32 {seconds} s batch "
          f"(T={int(conv_output_length(samples))} in the transformer) "
          f"({card})")
    del svc, model


# ------------------------------------------------------------------ phase 4
def run_training(report: dict, card: str, deterministic: bool) -> None:
    """2 optimizer steps (16 micro-steps) of the base configuration at full
    width and depth, bf16, micro-batch 8 of 2.3 s clips."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    tag = "train_deterministic" if deterministic else "train_default"
    cfg = default_config()
    if deterministic:
        cfg.audio.dropout = 0.0  # every stochastic rate: attention kernels
    k = cfg.training.accumulate_grad_batches
    if TRAIN_MICRO_STEPS != 2 * k:
        raise AssertionError(f"accumulate_grad_batches {k}: expected 8")
    rng = np.random.default_rng(2)
    batches = [_clip_batch(rng, cfg, TRAIN_B, TRAIN_SECONDS)
               for _ in range(TRAIN_MICRO_STEPS)]
    model = init_model(cfg, seed=0)
    state = TrainState.create(model, cfg)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith(("running_mean", "running_var"))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses = []
    events = []  # CUDA events around micro-steps 2-16
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i > 0:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        state, m = train_step(state, batch, seed=0)
        if i > 0:
            events[-1][1].record()
        losses.append(m["train_loss"])
        if i == 0:  # the first micro-step is warm-up; time the other 15
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        if i == k - 1:  # warmup_linear: the first optimizer step has lr 0
            first_moved = torch.stack([(p - start[n]).abs().max()
                                       for n, p in state.params.items()]
                                      ).max()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = _counts()
    ms = (t_end - t1) / (TRAIN_MICRO_STEPS - 1) * 1e3
    step_ms = [a.elapsed_time(b) for a, b in events]
    ev_ms = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in losses]
    moved = max((p - start[n]).abs().max().item()
                for n, p in state.params.items())
    stats_moved = max((b - stats0[n]).abs().max().item()
                      for n, b in model.named_buffers() if n in stats0)
    print(f"{tag}: {TRAIN_MICRO_STEPS} micro-steps in {t_end - t0:.1f} s; "
          f"launches {launches}; losses {[round(x, 6) for x in losses]}")
    print(f"{tag}: parameters moved {first_moved.item():.3g} after the "
          f"first optimizer step (lr 0), {moved:.3g} after the second; "
          f"running statistics moved {stats_moved:.3g}; peak memory "
          f"{peak:.2f} GiB")
    print(f"{tag}: {ms:.2f} ms per micro-step (B={TRAIN_B}, "
          f"{TRAIN_SECONDS} s; host clock, mean of micro-steps 2-16), "
          f"{TRAIN_B / ms * 1e3:.2f} train clips/s; CUDA events: median "
          f"{ev_ms:.2f} ms ({min(step_ms):.2f}-{max(step_ms):.2f}; the 2 "
          f"optimizer steps inside) ({card})")
    n_layers = model.audio_encoder.wav2vec2.cfg.num_layers
    n_attn = n_layers * TRAIN_MICRO_STEPS if deterministic else 0
    want = {"attention_fwd": n_attn, "attention_bwd": n_attn,
            "triplet_loss": TRAIN_MICRO_STEPS}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if first_moved.item() != 0.0 or not moved > 0.0 or not stats_moved > 0:
        raise AssertionError(f"{tag}: parameters/statistics did not move "
                             "as the schedule says")
    report["launches"][tag] = launches
    report[tag] = {"ms_per_micro_step": ms,
                   "event_ms_per_micro_step_median": ev_ms,
                   "event_ms_range": [min(step_ms), max(step_ms)],
                   "train_clips_per_s": TRAIN_B / ms * 1e3,
                   "peak_memory_gib": peak, "losses": losses}
    if not deterministic:
        if losses[0] == report["train_deterministic"]["losses"][0]:
            raise AssertionError("dropout had no effect on the loss")
        # the same seed from the same weights: the same micro-steps
        del state, model
        model = init_model(cfg, seed=0)
        state = TrainState.create(model, cfg)
        again = [train_step(state, b, seed=0)[1]["train_loss"].item()
                 for b in batches[:2]]
        print(f"{tag}: first two micro-steps again from seed 0: {again}")
        if again != losses[:2]:
            raise AssertionError(f"{tag} is not reproducible: {again}")
    del state, model


# ----------------------------------------------------------------- phase 4c
TRAINER_TRAIN, TRAINER_VAL = 128, 100  # synthetic clips; 100 val pairs
TRAINER_MICRO_STEPS, TRAINER_SANITY = 16, 2
RESUME_MICRO_STEPS = 8
CKPT_EMB_TOL = 1e-6  # served vs in-memory embeddings (0 expected)
# bootstrap recall vs the numpy loop: float32 distances computed in another
# order may swap near-equal neighbours; one swap moves the mean by 2e-5
RECALL_TOL = 1e-3
PLAIN_VERSIONS = (("attention", "mha_attention_plain"),
                  ("attention", "mha_attention_bwd_plain"),
                  ("loss", "fused_triplet_loss_plain"),
                  ("loss", "triplet_loss_bwd"),
                  ("loss", "fused_triplet_loss_and_grad_plain"))


def _val_batches(data, limit=None) -> int:
    """Batches of the four validation loaders, from their sizes: loaders 0
    and 1 hold n_val clips; loaders 2 and 3 batch the line clips by exact
    duration."""
    import math
    from collections import Counter

    b = data.data.val.batch_size
    fixed = math.ceil(len(data.val_dia) / b)
    lines = sum(math.ceil(n / b)
                for n in Counter(data.val_dia3.durations).values())
    per_loader = [fixed, fixed, lines, lines]
    return sum(n if limit is None else min(n, limit) for n in per_loader)


def _patch(module, name, wrapper):
    """Wrap module.name (looked up at call time by its callers); returns
    the undo."""
    real = getattr(module, name)
    setattr(module, name, wrapper(real))
    return lambda: setattr(module, name, real)


def _same_state(payload: dict, state_dict: dict) -> int:
    """Number of tensors of a saved payload equal to a state's; raises at
    the first that differs or is missing."""
    import torch

    n = 0

    def walk(a, b, path):
        nonlocal n
        if isinstance(a, torch.Tensor):
            if not torch.equal(a.cpu(), b.detach().cpu()):
                raise AssertionError(f"checkpoint tensor {path} differs")
            n += 1
        elif isinstance(a, dict):
            if a.keys() != b.keys():
                raise AssertionError(f"checkpoint keys at {path} differ")
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b, strict=True)):
                walk(x, y, f"{path}/{i}")
        elif a != b:
            raise AssertionError(f"checkpoint value {path}: {a} != {b}")

    walk(payload, state_dict, "")
    return n


def _plain_recall(candidates, references, seed, size, n_samples, n) -> float:
    """Mean recall@n over the bootstrap's subsets (the same draws), by a
    numpy loop: normalise, distances, stable argsort per row."""
    import numpy as np

    from peppa_tpu_torch.ops.metrics import bootstrap_indices

    idx = bootstrap_indices(len(candidates), size, n_samples, seed).numpy()
    hits = 0
    for ix in idx:
        x = candidates[ix] / np.linalg.norm(candidates[ix], axis=1,
                                            keepdims=True)
        y = references[ix] / np.linalg.norm(references[ix], axis=1,
                                            keepdims=True)
        ranked = np.argsort(1.0 - y @ x.T, axis=1, kind="stable")[:, :n]
        hits += int((ranked == np.arange(size)[:, None]).sum())
    return hits / (n_samples * size)


def _kept_inputs(inputs: dict, kernel: str):
    """A wrapper for a kernel's caller-side name that keeps a copy of the
    first CUDA inputs of each shape (dtype, autograd or not, lengths or
    not) it is given, then calls the kernel's wrapper as before."""
    import torch

    def wrap(real):
        def run(*args, **kw):
            x = args[0]
            grad = torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad for a in args)
            key = (kernel, tuple(x.shape), str(x.dtype).split(".")[1], grad,
                   kw.get("lengths") is not None)
            if x.is_cuda and key not in inputs:
                inputs[key] = (
                    [a.detach().clone() if isinstance(a, torch.Tensor) else a
                     for a in args],
                    {k: a.detach().clone() if isinstance(a, torch.Tensor)
                     else a for k, a in kw.items()})
            return real(*args, **kw)
        return run
    return wrap


def _hold_path_shapes(report: dict, inputs: dict,
                      tag: str = "trainer_shapes",
                      kernels=("attention", "triplet_loss")) -> None:
    """Each kernel against its plain version on the inputs a path gave it,
    the first of each shape, at phase 2's tolerances: for the trainer's two
    fits (`trainer_shapes`), attention on every validation batch shape (the
    2.3 s fixed loaders at B = 8 and the remainder's B = 4, the 1, 2 and 3 s
    line clips at B up to 8), the loss at every eval batch size and the
    micro-step's (with its gradient); for the pipeline's fit and scorer
    (`pipeline_shapes`), the same over the episode tree's clips and
    lines; for the evaluation entry (`evaluation_shapes`), attention at
    the shapes its paths gave it (`kernels`: the ones the path runs)."""
    import torch

    from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                    mha_attention_plain)
    from peppa_tpu_torch.ops.cuda.loss import (
        _launch, fused_triplet_loss, fused_triplet_loss_and_grad_plain,
        fused_triplet_loss_plain)

    rows = {kernel: [] for kernel in kernels}
    with torch.inference_mode():
        for key in sorted(inputs):
            kernel, shape, dtype, grad, _ = key
            args, kw = inputs[key]
            if kernel == "attention":
                got = mha_attention(*args, **kw)
                want = mha_attention_plain(*args, **kw)
                err = (got.float() - want.float()).abs().max().item()
                tol = f"{TOL_ATTN[dtype]}"
                if not err <= TOL_ATTN[dtype]:
                    raise AssertionError(f"attention {shape} {dtype} in "
                                         f"{tag}: {err}")
            else:
                v, a, margin = args
                v, a = v.float(), a.float()  # as the kernel reads them
                if grad:
                    got = _launch(v, a, margin, grad=True)
                    want = fused_triplet_loss_and_grad_plain(v, a, margin)
                else:
                    got = (fused_triplet_loss(v, a, margin),)
                    want = (fused_triplet_loss_plain(v, a, margin),)
                torch.testing.assert_close(got[0], want[0], rtol=LOSS_RTOL,
                                           atol=LOSS_ATOL)
                for g, w in zip(got[1:], want[1:]):
                    torch.testing.assert_close(g, w, rtol=LOSS_GRAD_RTOL,
                                               atol=LOSS_ATOL)
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                tol = (f"rtol {LOSS_RTOL} atol {LOSS_ATOL}"
                       + (f", gradients rtol {LOSS_GRAD_RTOL}" if grad
                          else ""))
            print(f"{tag.replace('_', ' ')}: {kernel} {list(shape)} {dtype}"
                  f"{' with the gradient' if grad else ''}: max|d|="
                  f"{err:.3g} against the plain version ({tol})")
            rows[kernel].append({"shape": list(shape), "dtype": dtype,
                                 "grad": grad, "max_abs_err": err})
    for kernel in rows:
        if not rows[kernel]:
            raise AssertionError(f"{tag}: {kernel} was given no inputs")
        report[kernel][tag] = rows[kernel]
        report[kernel]["max_abs_err"] = max(
            [report[kernel]["max_abs_err"]]
            + [r["max_abs_err"] for r in rows[kernel]])


def _timed(record: dict, key: str):
    """A wrapper that appends each call's host seconds to record[key]."""
    def wrap(real):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            record[key].append(time.perf_counter() - t0)
            return out
        return run
    return wrap


def _timed_validation(record: dict):
    """A wrapper of `run_validation` that appends (seconds, metrics) to
    record["validation"]."""
    def wrap(real):
        def run(*args, **kw):
            t0 = time.perf_counter()
            metrics = real(*args, **kw)
            record["validation"].append((time.perf_counter() - t0, metrics))
            return metrics
        return run
    return wrap


def _count_on_card(record: dict):
    """A wrapper of a plain version that counts its calls on CUDA tensors
    in record["plain"]."""
    import torch

    def wrap(real):
        def run(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                record["plain"] += 1
            return real(*args, **kw)
        return run
    return wrap


def _copy_into(dst, src) -> None:
    """Copy a state dict's tensors into a host copy of it, in place."""
    import torch

    if isinstance(dst, torch.Tensor):
        dst.copy_(src.detach(), non_blocking=True)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for x, y in zip(dst, src, strict=True):
            _copy_into(x, y)


def run_trainer(report: dict, card: str) -> None:
    """`Trainer.fit` of the base configuration at full width and depth,
    bf16, the default attention route (dropout 0.1, layer-drop 0.05), on
    `SyntheticPigData`: sanity validation, 16 micro-steps (2 optimizer
    steps), the full four-loader validation, the dual-monitor and last
    checkpoints; then the best checkpoint served by
    `EncoderService.from_checkpoint`, and a resume from last.ckpt for 8
    more micro-steps."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.data.datamodule import SyntheticPigData
    from peppa_tpu_torch.models import wav2vec2
    from peppa_tpu_torch.ops import loss as loss_op
    from peppa_tpu_torch.ops.cuda import attention, loss
    from peppa_tpu_torch.serving import EncoderService
    from peppa_tpu_torch.evaluation import validation
    from peppa_tpu_torch.training import checkpoint, loop

    cfg = default_config()
    cfg.training.max_epochs = 1
    cfg.training.limit_train_batches = TRAINER_MICRO_STEPS
    cfg.training.num_sanity_val_steps = TRAINER_SANITY
    data = SyntheticPigData(cfg, n_train=TRAINER_TRAIN, n_val=TRAINER_VAL)
    data.setup()
    sanity = _val_batches(data, TRAINER_SANITY)
    full = _val_batches(data)
    val_clips = 2 * TRAINER_VAL + 2 * len(data.val_dia3)

    record = {"validation": [], "snapshot": [], "write": [], "plain": 0,
              "loaded": None, "recall": []}

    def held_load(real):
        def run(path, state=None):
            state, meta = real(path, state)
            saved = torch.load(path, map_location="cpu", weights_only=True)
            record["loaded"] = _same_state(saved, state.state_dict())
            return state, meta
        return run

    def kept_recall(real):
        def run(candidates, references, seed=0, **kw):
            out = real(candidates, references, seed, **kw)
            record["recall"].append((candidates.cpu().numpy(),
                                     references.cpu().numpy(), seed, kw,
                                     out.mean().item()))
            return out
        return run

    modules = {"attention": attention, "loss": loss}
    real_snapshot = checkpoint.snapshot
    inputs: dict = {}
    undo = [_patch(wav2vec2, "mha_attention",
                   _kept_inputs(inputs, "attention")),
            _patch(loss_op, "fused_triplet_loss",
                   _kept_inputs(inputs, "triplet_loss")),
            _patch(loop, "run_validation", _timed_validation(record)),
            _patch(loop, "load_checkpoint", held_load),
            _patch(checkpoint, "snapshot", _timed(record, "snapshot")),
            _patch(checkpoint, "_publish", _timed(record, "write")),
            _patch(validation, "resampled_recall", kept_recall)]
    undo += [_patch(modules[m], name, _count_on_card(record))
             for m, name in PLAIN_VERSIONS]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        trainer = loop.Trainer(cfg, log_dir=log_dir)
        state = trainer.fit(data)
        fit_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        clips_per_s = trainer.timer.items_per_sec
        (sanity_s, _), (val_s, metrics) = record["validation"]
        print(f"trainer: fit in {fit_s:.1f} s (sanity validation {sanity} "
              f"batches, {TRAINER_MICRO_STEPS} micro-steps, validation "
              f"{full} batches of {val_clips} clips, checkpoints); "
              f"launches {launches}; plain versions on the card "
              f"{record['plain']}; metrics {metrics}")
        n_layers = state.model.audio_encoder.wav2vec2.cfg.num_layers
        want = {"attention_fwd": n_layers * (sanity + full),
                "attention_bwd": 0,
                "triplet_loss": sanity + full + TRAINER_MICRO_STEPS}
        if launches != want:
            raise AssertionError(f"trainer launches {launches} != {want}")
        if record["plain"]:
            raise AssertionError(f"{record['plain']} plain-version calls "
                                 "on the card")
        keys = {"val_loss", "val_rec_fixed", "valnarr_loss",
                "valnarr_rec_fixed", "val_triplet", "valnarr_triplet"}
        if set(metrics) != keys or not all(np.isfinite(list(
                metrics.values()))):
            raise AssertionError(f"validation metrics {metrics}")
        if state.step != TRAINER_MICRO_STEPS:
            raise AssertionError(f"trainer stopped at step {state.step}")
        # the full validation's bootstrap against a plain numpy loop over
        # the same subsets (last two recall calls: val, valnarr)
        for c, r, seed, kw, got in record["recall"][-2:]:
            want = _plain_recall(c, r, seed, **kw)
            print(f"trainer: bootstrap recall@{kw['n']} of {kw['size']} "
                  f"over {kw['n_samples']} subsets {got:.6f}, plain numpy "
                  f"{want:.6f}")
            if not abs(got - want) <= RECALL_TOL:
                raise AssertionError(f"bootstrap recall {got} vs {want}")
        # the host's share: making the 400 validation clips and batching
        # them, with no device work
        t0 = time.perf_counter()
        host_batches = sum(1 for loader in data.val_loaders()
                           for _ in loader)
        host_s = time.perf_counter() - t0
        print(f"trainer: the host makes the validation's {host_batches} "
              f"batches alone in {host_s:.2f} s")

        ckdir = os.path.join(trainer.version_dir, "checkpoints")
        last = os.path.join(ckdir, "last.ckpt")
        bests = sorted(f for f in os.listdir(ckdir)
                       if f.startswith("epoch=0-") and f.endswith(".ckpt"))
        inodes = {os.stat(os.path.join(ckdir, f)).st_ino
                  for f in bests + ["last.ckpt"]}
        if len(bests) != 2 or len(inodes) != 1:
            raise AssertionError(f"checkpoints {os.listdir(ckdir)}: "
                                 f"{len(inodes)} inodes")
        ckpt_bytes = os.path.getsize(last)
        saved = torch.load(last, map_location="cpu", weights_only=True)
        n_saved = _same_state(saved, state.state_dict())
        del saved
        (snap_s,), (write_s,) = record["snapshot"], record["write"]
        print(f"trainer: checkpoints {bests + ['last.ckpt']} are one file "
              f"(one inode) of {ckpt_bytes} bytes, {n_saved} tensors equal "
              f"to the trained state; host copy {snap_s:.3f} s, "
              f"serialise and publish {write_s:.3f} s (background writer)")
        # the host copy in parts: the trainer's snapshot pinned its host
        # memory afresh; a second snapshot once that one is freed (PyTorch
        # caches pinned blocks), then the copies alone into its buffers
        t0 = time.perf_counter()
        again = real_snapshot(state)
        again_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _copy_into(again, state.state_dict())
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        del again
        print(f"trainer: host copy of the state: first {snap_s:.3f} s, "
              f"again {again_s:.3f} s, the copies alone into pinned "
              f"buffers {copy_s:.3f} s")

        # the best checkpoint, served: the same embeddings as the trained
        # model in memory, through the same padded batch
        rng = np.random.default_rng(5)
        wave = rng.normal(scale=0.1, size=(int(round(
            2.3 * cfg.data.audio_sample_rate)),)).astype(np.float32)
        w, h = cfg.data.target_size
        clip = rng.integers(0, 256, size=(23, h, w, 3), dtype=np.uint8)
        served = EncoderService.from_checkpoint(trainer.version_dir)
        memory = EncoderService(state.model, cfg)
        diff = max(float(np.abs(served.embed_audio([wave])
                                - memory.embed_audio([wave])).max()),
                   float(np.abs(served.embed_video([clip])
                                - memory.embed_video([clip])).max()))
        print(f"trainer: from_checkpoint embeds a 2.3 s pair as the "
              f"trained model does: max|d| = {diff:.3g} (tol {CKPT_EMB_TOL})")
        if not diff <= CKPT_EMB_TOL:
            raise AssertionError(f"from_checkpoint embeddings differ by "
                                 f"{diff}")
        del served, memory

        # resume from last.ckpt: the loaded state equals the file
        cfg.training.max_epochs = 2
        cfg.training.limit_train_batches = RESUME_MICRO_STEPS
        cfg.training.num_sanity_val_steps = 0
        cfg.training.limit_val_batches = TRAINER_SANITY
        del trainer, state
        _reset_counts()
        resumed = loop.Trainer(cfg, log_dir=log_dir)
        state = resumed.fit(data, resume_from=last)
        resume_launches = _counts()
        print(f"trainer: resumed from last.ckpt ({record['loaded']} "
              f"tensors loaded equal to the file), {RESUME_MICRO_STEPS} "
              f"more micro-steps to step {state.step}; launches "
              f"{resume_launches}")
        if record["loaded"] is None or state.step != \
                TRAINER_MICRO_STEPS + RESUME_MICRO_STEPS:
            raise AssertionError("resume did not load or did not train")
        resume_val = _val_batches(data, TRAINER_SANITY)
        want = {"attention_fwd": n_layers * resume_val, "attention_bwd": 0,
                "triplet_loss": resume_val + RESUME_MICRO_STEPS}
        if resume_launches != want or record["plain"]:
            raise AssertionError(f"resume launches {resume_launches} != "
                                 f"{want}; plain versions on the card "
                                 f"{record['plain']}")
        print(f"trainer: {clips_per_s:.2f} train clips/s (StepTimer: "
              f"the clips of micro-steps 4-{TRAINER_MICRO_STEPS} over the "
              f"time from the end of the 3rd); sanity validation "
              f"{sanity_s:.2f} s; full validation {val_s:.2f} s "
              f"({val_clips} clips); checkpoint {ckpt_bytes} bytes, host "
              f"copy {snap_s:.3f} s, write {write_s:.3f} s; peak memory "
              f"{peak:.2f} GiB ({card})")
        report["launches"]["trainer"] = launches
        report["launches"]["trainer_resume"] = resume_launches
        report["trainer"] = {
            "train_clips_per_s": clips_per_s, "sanity_val_s": sanity_s,
            "val_s": val_s, "val_clips": val_clips,
            "val_host_batches_s": host_s,
            "checkpoint_bytes": ckpt_bytes, "checkpoint_host_copy_s": snap_s,
            "checkpoint_host_copy_again_s": again_s,
            "checkpoint_copy_only_s": copy_s,
            "checkpoint_write_s": write_s, "peak_memory_gib": peak,
            "metrics": metrics}
    finally:
        for u in undo:
            u()
        shutil.rmtree(log_dir, ignore_errors=True)
    # after the fits' counts were read and every wrapper was put back
    _hold_path_shapes(report, inputs)


# ----------------------------------------------------------------- phase 4d
# the episode tree: dialog train 1-16, dialog val 197-209, narration val
# 1-13, two 12 s clips each (SPLIT_SPEC's episode numbers)
PIPELINE_EPISODES = {"dialog": tuple(range(1, 17)) + tuple(range(197, 210)),
                     "narration": tuple(range(1, 14))}
PIPELINE_CLIPS, PIPELINE_CLIP_S = 2, 12.0
PIPELINE_FIELDS = ("video", "audio", "video_duration", "audio_duration",
                   "video_frames", "audio_samples")


def _dir_bytes(root: str, pattern: str) -> int:
    import glob

    return sum(os.path.getsize(p)
               for p in glob.glob(os.path.join(root, pattern)))


def _batch_bytes(batch) -> int:
    return sum(getattr(batch, f).numel() * getattr(batch, f).element_size()
               for f in PIPELINE_FIELDS)


def _copy_rates(batch) -> tuple:
    """GB/s of one batch to the card: its pinned tensors on a side stream
    (CUDA events around the copies), and the same batch as pageable numpy
    arrays through `ClipBatch.to` (host clock to a synchronise); each the
    median of 10 after 2."""
    import numpy as np
    import torch

    from peppa_tpu_torch.data.types import ClipBatch

    n_bytes = _batch_bytes(batch)
    side = torch.cuda.Stream()
    pinned, pageable = [], []
    host = ClipBatch(**{f: getattr(batch, f).numpy().copy()
                        for f in PIPELINE_FIELDS})
    for _ in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            moved = [getattr(batch, f).to("cuda", non_blocking=True)
                     for f in PIPELINE_FIELDS]
            end.record(side)
        end.synchronize()
        pinned.append(start.elapsed_time(end) / 1e3)
        del moved
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.to("cuda")
        torch.cuda.synchronize()
        pageable.append(time.perf_counter() - t0)
    return (n_bytes, n_bytes / float(np.median(pinned[2:])) / 1e9,
            n_bytes / float(np.median(pageable[2:])) / 1e9)


def run_pipeline(report: dict, card: str, root: str) -> None:
    """`Trainer.fit` of the base configuration (the defaults: jittered 2.3 s
    windows, dropout, layer-drop, B=8, k=8, the native loader) over
    `PigData` on an episode tree written at full size under `root` (kept
    for phase 6): the item caches and the pack built once, sanity
    validation, 16 micro-steps, the full validation, the checkpoints; then
    `TripletScorer` on the dialog val lines with the trained model.  Around
    it: the native loader alone over one epoch's plan, the copy rate of
    one 2.3 s batch pinned and pageable, and the step alone on the fit's
    16 batches."""
    import itertools
    import random
    import shutil
    from collections import Counter

    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.data import cache as cache_module
    from peppa_tpu_torch.data.datamodule import PigData
    from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
    from peppa_tpu_torch.evaluation.triplet import TripletScorer
    from peppa_tpu_torch.models import wav2vec2
    from peppa_tpu_torch.native.loader import (NativeBatchLoader, NativePack,
                                               bucket_plan)
    from peppa_tpu_torch.ops import loss as loss_op
    from peppa_tpu_torch.ops.cuda import attention, loss
    from peppa_tpu_torch.training import loop
    from peppa_tpu_torch.training.step import train_step
    from peppa_tpu_torch.utils.prefetch import Prefetcher

    undo = []
    try:
        cfg = default_config()
        d = cfg.data
        d.data_dir = os.path.join(root, "data")
        w, h = d.target_size
        t0 = time.perf_counter()
        for fragment, episodes in PIPELINE_EPISODES.items():
            make_synthetic_episode_tree(
                d.data_dir, target_size=(w, h), fragment_type=fragment,
                episodes=episodes, clips_per_episode=PIPELINE_CLIPS,
                clip_seconds=PIPELINE_CLIP_S,
                sample_rate=d.audio_sample_rate, seed=0, correlated=True)
        tree_s = time.perf_counter() - t0
        tree_bytes = _dir_bytes(d.data_dir, "out/*/*/*/*.npz")
        n_files = PIPELINE_CLIPS * sum(map(len, PIPELINE_EPISODES.values()))
        print(f"pipeline: episode tree of {n_files} clips of "
              f"{PIPELINE_CLIP_S} s ({w}x{h}, {d.audio_sample_rate} Hz) "
              f"written in {tree_s:.1f} s, {tree_bytes} bytes")

        cfg.training.max_epochs = 1
        cfg.training.limit_train_batches = TRAINER_MICRO_STEPS
        cfg.training.num_sanity_val_steps = TRAINER_SANITY
        data = PigData(cfg)
        record = {"setup": [], "pack": [], "validation": [], "plain": 0}
        inputs: dict = {}
        modules = {"attention": attention, "loss": loss}
        undo += [_patch(data, "setup", _timed(record, "setup")),
                 _patch(cache_module, "pack_from_dataset",
                        _timed(record, "pack")),
                 _patch(loop, "run_validation", _timed_validation(record)),
                 _patch(wav2vec2, "mha_attention",
                        _kept_inputs(inputs, "attention")),
                 _patch(loss_op, "fused_triplet_loss",
                        _kept_inputs(inputs, "triplet_loss"))]
        undo += [_patch(modules[m], name, _count_on_card(record))
                 for m, name in PLAIN_VERSIONS]
        random.seed(0)  # the jitter of the train windows (global random)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        NativeBatchLoader.served = 0
        Prefetcher.side_stream_copies = 0
        _reset_counts()
        t0 = time.perf_counter()
        trainer = loop.Trainer(cfg, log_dir=os.path.join(root, "logs"))
        state = trainer.fit(data)
        fit_s = time.perf_counter() - t0
        launches = _counts()
        served, copies = NativeBatchLoader.served, \
            Prefetcher.side_stream_copies
        peak = torch.cuda.max_memory_allocated() / 2**30
        clips_per_s = trainer.timer.items_per_sec
        (sanity_s, _), (val_s, metrics) = record["validation"]
        cache_s, pack_s = record["setup"][0], record["pack"][0]
        cache_bytes = _dir_bytes(os.path.join(d.data_dir, "out"),
                                 "items-*/*.npz")
        pack_path = os.path.join(data.train.cache_dir, "items.pack")
        pack_bytes = os.path.getsize(pack_path)
        n_items = [len(x) for x in (data.train, data.val_dia, data.val_narr,
                                    data.val_dia3, data.val_narr3)]
        print(f"pipeline: item caches of {sum(n_items)} clips (train "
              f"{n_items[0]}, val fixed {n_items[1]} + {n_items[2]}, val "
              f"lines {n_items[3]} + {n_items[4]}) built in {cache_s:.1f} s, "
              f"{cache_bytes} bytes; the pack of the {n_items[0]} train "
              f"clips in {pack_s:.1f} s, {pack_bytes} bytes")

        # the validation's batches made on the host alone, no device work
        t0 = time.perf_counter()
        per_loader = [sum(1 for _ in loader) for loader in data.val_loaders()]
        host_s = time.perf_counter() - t0
        sanity = sum(min(n, TRAINER_SANITY) for n in per_loader)
        full = sum(per_loader)
        print(f"pipeline: fit in {fit_s:.1f} s (sanity validation {sanity} "
              f"batches, {TRAINER_MICRO_STEPS} micro-steps, validation "
              f"{full} batches {per_loader}, checkpoints); native batches "
              f"served {served}; side-stream copies {copies}; launches "
              f"{launches}; plain versions on the card {record['plain']}; "
              f"metrics {metrics}")
        n_layers = state.model.audio_encoder.wav2vec2.cfg.num_layers
        want = {"attention_fwd": n_layers * (sanity + full),
                "attention_bwd": 0,
                "triplet_loss": sanity + full + TRAINER_MICRO_STEPS}
        if launches != want:
            raise AssertionError(f"pipeline launches {launches} != {want}")
        if served != TRAINER_MICRO_STEPS \
                or copies != sanity + full + TRAINER_MICRO_STEPS:
            raise AssertionError(f"native batches {served}, side-stream "
                                 f"copies {copies}")
        if record["plain"]:
            raise AssertionError(f"{record['plain']} plain-version calls "
                                 "on the card")
        if min(n_items[1:3]) < 100:
            raise AssertionError(f"fixed val sets {n_items[1:3]} < 100 clips")
        keys = {"val_loss", "val_rec_fixed", "valnarr_loss",
                "valnarr_rec_fixed", "val_triplet", "valnarr_triplet"}
        if set(metrics) != keys or not all(np.isfinite(list(
                metrics.values()))):
            raise AssertionError(f"validation metrics {metrics}")
        if state.step != TRAINER_MICRO_STEPS:
            raise AssertionError(f"pipeline fit stopped at step {state.step}")

        # TripletScorer on the dialog val lines (the cache of val_dia3)
        _reset_counts()
        t0 = time.perf_counter()
        scorer = TripletScorer("dialog", ["val"], target_size=(w, h),
                               audio_sample_rate=d.audio_sample_rate,
                               data_dir=d.data_dir)
        tri = scorer.evaluate(state.model, batch_size=d.val.batch_size,
                              n_samples=100, seed=0)
        scorer_s = time.perf_counter() - t0
        scorer_launches = _counts()
        acc = tri["accuracy"]
        print(f"pipeline: TripletScorer over {len(scorer.dataset)} dialog "
              f"val lines in {scorer_s:.2f} s: accuracy {acc.mean():.4f} "
              f"(100 rounds); launches {scorer_launches}")
        want = {"attention_fwd": n_layers * per_loader[2],
                "attention_bwd": 0, "triplet_loss": per_loader[2]}
        if scorer_launches != want or record["plain"]:
            raise AssertionError(f"scorer launches {scorer_launches} != "
                                 f"{want}; plain {record['plain']}")
        if acc.shape != (100,) or not ((acc >= 0) & (acc <= 1)).all() \
                or tuple(scorer._video.shape) != (len(scorer.dataset), 512):
            raise AssertionError(f"scorer output {acc.shape}")
        for u in undo:
            u()
        undo = []

        # the native loader alone over epoch 0's plan: no device work
        pack = NativePack(pack_path)
        plan = bucket_plan(
            pack.durations(), buckets=tuple(cfg.tpu.bucket_durations),
            batch_size=d.train.batch_size, target_hw=d.target_size,
            sample_rate=d.audio_sample_rate, shuffle=d.train.shuffle,
            seed=cfg.training.seed)
        t0 = time.perf_counter()
        loaded = 0
        for b in NativeBatchLoader(pack, plan, n_threads=max(d.num_workers, 1),
                                   depth=2 * cfg.tpu.prefetch):
            loaded += _batch_bytes(b)
        loader_s = time.perf_counter() - t0
        print(f"pipeline: native loader alone, epoch 0's {len(plan)} "
              f"batches of {d.train.batch_size} ({loaded} bytes, pinned) in "
              f"{loader_s:.3f} s: {len(plan) / loader_s:.1f} batches/s, "
              f"{loaded / loader_s / 1e9:.2f} GB/s")
        entry = next(p for p in plan if p[1][0] == round(TRAIN_SECONDS * 10))
        one = next(iter(NativeBatchLoader(pack, [entry])))
        n_bytes, pinned_gbs, pageable_gbs = _copy_rates(one)
        print(f"pipeline: one {TRAIN_SECONDS} s B={len(entry[0])} batch "
              f"({n_bytes} bytes) to the card: pinned on a side stream "
              f"{pinned_gbs:.2f} GB/s, pageable through ClipBatch.to "
              f"{pageable_gbs:.2f} GB/s")

        # the step alone on the fit's 16 batches (already on the card)
        batches = [b.to("cuda") for b in itertools.islice(
            data.train_batches(0), TRAINER_MICRO_STEPS)]
        mix = Counter(f"{b.video.shape[1] / 10:.1f} s"
                      for b in batches)
        for i, b in enumerate(batches):
            state, m = train_step(state, b, seed=1)
            if i == 2:
                m["train_loss"].item()
                t1 = time.perf_counter()
        m["train_loss"].item()
        alone = (TRAINER_MICRO_STEPS - 3) * d.train.batch_size / (
            time.perf_counter() - t1)
        step_alone_23 = report["train_default"]["train_clips_per_s"]
        print(f"pipeline: {clips_per_s:.2f} train clips/s (StepTimer, "
              f"micro-steps 4-{TRAINER_MICRO_STEPS}); the step alone on the "
              f"same batches {alone:.2f} (buckets {dict(mix)}); phase 4b's "
              f"step alone on 2.3 s clips {step_alone_23:.2f}; sanity "
              f"validation {sanity_s:.2f} s; full validation {val_s:.2f} s "
              f"({sum(n_items[1:])} clips; phase 4c "
              f"{report['trainer']['val_s']:.2f} s), its batches on the host "
              f"alone {host_s:.2f} s; peak memory {peak:.2f} GiB ({card})")
        report["launches"]["pipeline"] = launches
        report["launches"]["pipeline_scorer"] = scorer_launches
        report["pipeline"] = {
            "tree_s": tree_s, "tree_bytes": tree_bytes, "clips": n_items,
            "cache_s": cache_s, "cache_bytes": cache_bytes,
            "pack_s": pack_s, "pack_bytes": pack_bytes,
            "train_clips_per_s": clips_per_s,
            "step_alone_clips_per_s": alone, "buckets": dict(mix),
            "sanity_val_s": sanity_s, "val_s": val_s,
            "val_host_batches_s": host_s, "native_batches": served,
            "side_stream_copies": copies,
            "loader_batches_per_s": len(plan) / loader_s,
            "loader_gb_per_s": loaded / loader_s / 1e9,
            "copy_bytes": n_bytes, "copy_pinned_gb_per_s": pinned_gbs,
            "copy_pageable_gb_per_s": pageable_gbs,
            "scorer_s": scorer_s, "scorer_accuracy": float(acc.mean()),
            "peak_memory_gib": peak, "metrics": metrics}
        del state, trainer, batches
    finally:
        for u in undo:
            u()
        shutil.rmtree(os.path.join(root, "logs"), ignore_errors=True)
    _hold_path_shapes(report, inputs, "pipeline_shapes")


# ------------------------------------------------------------------ phase 6
EVAL_SAMPLES = 500  # the battery's bootstrap subsets and triplet rounds
TARGETED_POS = ("ADJ", "VERB", "NOUN")
TARGETED_PAIRS = 14  # per POS tag: 42 minimal pairs, 84 clips
WEIGHT_NORM_RTOL = 1e-6  # the positional conv's g and v
TOWER_B, TOWER_SECONDS = 8, 2.3
RUN_META = {"monitor": "valnarr_triplet", "mode": "max",
            "best_model_score": 0.5, "epoch": 0, "metrics": {}}


def _write_run_dirs(model, cfg, runs: str) -> dict:
    """One run directory of each format under `runs`, each holding `model`
    as its best checkpoint: the port's (torch.save zip, sidecar,
    hparams.yaml), the JAX package's (flax msgpack by the port's encoder,
    sidecar, hparams.yaml) and the reference's (a Lightning file, no
    sidecar, no hparams.yaml: the embedded hyper_parameters give the
    config).  kind -> (log_dir, write seconds, file bytes)."""
    import json

    import numpy as np

    from peppa_tpu_torch.models.convert import (export_jax_variables,
                                                save_reference_checkpoint)
    from peppa_tpu_torch.training.checkpoint import save_checkpoint
    from peppa_tpu_torch.training.flax_msgpack import write_checkpoint
    from peppa_tpu_torch.training.state import TrainState

    variables = export_jax_variables(model)
    out = {}
    for kind in ("port", "jax", "lightning"):
        log_dir = os.path.join(runs, kind)
        vdir = os.path.join(log_dir, "version_0")
        path = os.path.join(vdir, "checkpoints",
                            "epoch=0-valnarr_triplet=0.50.ckpt")
        os.makedirs(os.path.dirname(path))
        meta = dict(RUN_META, best_model_path=path)
        t0 = time.perf_counter()
        if kind == "port":
            cfg.dump(os.path.join(vdir, "hparams.yaml"))
            save_checkpoint(path, TrainState.create(model, cfg), meta)
        elif kind == "jax":
            cfg.dump(os.path.join(vdir, "hparams.yaml"))
            write_checkpoint(path, {"step": np.asarray(0, np.int32),
                                    **variables, "opt_state": {}})
            with open(path + ".json", "w") as f:
                json.dump(meta, f)
        else:
            save_reference_checkpoint(path, variables, cfg,
                                      monitor=meta["monitor"],
                                      score=meta["best_model_score"])
        out[kind] = (log_dir, time.perf_counter() - t0,
                     os.path.getsize(path))
    return out


def _same_weights(loaded, source) -> float:
    """Raise unless `loaded` holds `source`'s parameters and statistics:
    equal, except the weight-norm pair within WEIGHT_NORM_RTOL; returns
    the pair's largest relative difference."""
    import torch

    got, want = loaded.state_dict(), source.state_dict()
    if got.keys() != want.keys():
        raise AssertionError(f"state dict keys differ: "
                             f"{sorted(set(got) ^ set(want))[:4]}")
    worst = 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        if k.endswith(("pos_conv_g", "pos_conv_v")):
            rel = ((g - w).abs().max() / w.abs().max()).item()
            worst = max(worst, rel)
            if not rel <= WEIGHT_NORM_RTOL:
                raise AssertionError(f"{k}: relative difference {rel}")
        elif not torch.equal(g, w):
            raise AssertionError(f"{k} differs from the source's")
    return worst


def _targeted_eval_sets(data_dir: str, cfg, rng) -> int:
    """data/eval/eval_set_narration_{POS}.csv: TARGETED_PAIRS minimal
    pairs per tag, each two cuts of 0.4-1.5 s from one of the tree's
    narration clips, each the other's counterexample; returns the clips."""
    import csv
    import glob

    w, h = cfg.data.target_size
    files = sorted(glob.glob(os.path.join(
        data_dir, "out", f"{w}x{h}", "narration", "*", "*.npz")))
    os.makedirs(os.path.join(data_dir, "eval"), exist_ok=True)
    n = 0
    for p, pos in enumerate(TARGETED_POS):
        rows = []
        for i in range(TARGETED_PAIRS):
            episode = files[(p * TARGETED_PAIRS + i) % len(files)]
            t0 = float(rng.uniform(0.5, 7.0))
            t1 = t0 + float(rng.uniform(0.4, 1.5))
            t2 = t1 + float(rng.uniform(0.2, 1.0))
            t3 = t2 + float(rng.uniform(0.4, 1.5))
            words = (f"{pos.lower()}{i}a", f"{pos.lower()}{i}b")
            for j, (start, end) in enumerate(((t0, t1), (t2, t3))):
                rows.append([2 * i + j, episode, round(start, 3),
                             round(end, 3), f"the {words[j]} one",
                             words[j], words[1 - j], 2 * i + 1 - j])
        with open(os.path.join(data_dir, "eval",
                               f"eval_set_narration_{pos}.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["id", "episode_filepath", "clipStart",
                             "clipEnd", "transcript", "target_word",
                             "distractor_word", "id_counterexample"])
            writer.writerows(rows)
        n += len(rows)
    return n


def _counted_predict(record: dict):
    """A wrapper of `evaluation.make_predict` whose forwards count the
    batches they take in record["batches"] and add their seconds, to a
    synchronise after each, to record["forward_s"]."""
    import torch

    def wrap(real):
        def make(model, device=None):
            run = real(model, device)

            def counted(batch):
                record["batches"] += 1
                t0 = time.perf_counter()
                out = run(batch)
                torch.cuda.synchronize()
                record["forward_s"] += time.perf_counter() - t0
                return out
            return counted
        return make
    return wrap


def _tower_ms(cfg, rng) -> tuple:
    """One full-width video encode of B=8 2.3 s clips with a config's
    video tower, from seeded weights: (median ms of 5 after 1, the
    embeddings' largest |norm - 1|)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.models.dual_encoder import init_model

    model = init_model(cfg, seed=0)
    batch = _clip_batch(rng, cfg, TOWER_B, TOWER_SECONDS)
    video = torch.from_numpy(batch.video).cuda()
    frames = torch.from_numpy(batch.video_frames).cuda()
    times = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = model.encode_video(video, frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    v = v.float().cpu().numpy()
    if v.shape != (TOWER_B, 512) or not np.isfinite(v).all():
        raise AssertionError(f"tower embeddings {v.shape}")
    del model
    return (float(np.median(times[1:])) * 1e3,
            float(np.abs(np.linalg.norm(v, axis=1) - 1).max()))


def run_evaluation(report: dict, card: str, root: str) -> None:
    """The evaluation entry at full width (`hparams_base.yaml`, bf16, seeded
    weights): the model written as a run directory of each format and read
    back by `load_best_model` on the card (weights equal to the source's,
    a 2.3 s B=8 batch embedded bit-identically); `python -m
    peppa_tpu_torch.evaluate` on the JAX-format directory over phase 4d's
    episode tree (the battery, 500 bootstrap subsets and triplet rounds);
    `python -m peppa_tpu_torch.targeted_eval --run` on minimal pairs cut
    from the tree's narration clips; one video encode each of the static,
    r3d_18 and mc3_18 configurations; then kernel 1 against its plain
    version at the shapes the battery and the targeted path gave it."""
    import csv
    import logging
    import random

    import numpy as np
    import torch

    from peppa_tpu_torch import evaluate, targeted_eval
    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.data import dataset
    from peppa_tpu_torch.evaluation import evaluation, targeted
    from peppa_tpu_torch.models import wav2vec2
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.cuda import attention, loss
    from peppa_tpu_torch.training.checkpoint import load_best_model

    cfg = default_config()  # hparams_base.yaml: bf16, full width
    cfg.data.data_dir = os.path.join(root, "data")  # phase 4d's tree
    rng = np.random.default_rng(6)
    record = {"plain": 0, "batches": 0, "forward_s": 0.0, "cache": []}
    inputs = {"battery": {}, "targeted": {}}
    stats: dict = {}
    n_layers = cfg.audio.num_layers or 12
    modules = {"attention": attention, "loss": loss}
    undo = [_patch(modules[m], name, _count_on_card(record))
            for m, name in PLAIN_VERSIONS]
    undo.append(_patch(evaluation, "make_predict", _counted_predict(record)))
    undo += [_patch(module, "atomic_cache_build", _timed(record, "cache"))
             for module in (dataset, targeted)]
    try:
        # the three run directories, and load_best_model of each
        source = init_model(cfg, seed=0)
        written = _write_run_dirs(source, cfg, os.path.join(root, "runs"))
        batch = _clip_batch(rng, cfg, TRAIN_B, TRAIN_SECONDS)
        _reset_counts()
        with torch.inference_mode():
            want = source(batch.to("cuda"))
        stats["load_s"], stats["write_s"], stats["bytes"] = {}, {}, {}
        for kind, (log_dir, write_s, n_bytes) in written.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, config, path = load_best_model(
                os.path.join(log_dir, "version_0"))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            rel = _same_weights(model, source)
            with torch.inference_mode():
                got = model(batch.to("cuda"))
            same = (torch.equal(got.video, want.video)
                    and torch.equal(got.audio, want.audio))
            print(f"evaluation: {kind} run directory written in "
                  f"{write_s:.2f} s ({n_bytes} bytes), load_best_model on "
                  f"the card {load_s:.2f} s; weights equal to the source's "
                  f"(weight-norm pair max rel {rel:.3g}); the 2.3 s B=8 "
                  f"batch embeds {'bit-identically' if same else 'apart'}")
            if not same:
                raise AssertionError(f"{kind}: embeddings differ")
            if config.to_dict()["audio"] != cfg.to_dict()["audio"] \
                    and kind != "lightning":
                raise AssertionError(f"{kind}: config differs")
            stats["load_s"][kind], stats["write_s"][kind] = load_s, write_s
            stats["bytes"][kind] = n_bytes
            del model
        report["launches"]["checkpoint_formats"] = _counts()
        want_launches = {"attention_fwd": 4 * n_layers, "attention_bwd": 0,
                         "triplet_loss": 0}
        if report["launches"]["checkpoint_formats"] != want_launches:
            raise AssertionError(f"format launches "
                                 f"{report['launches']['checkpoint_formats']}")
        del source

        # the battery CLI on the JAX-format directory
        results = os.path.join(root, "results")
        for path_name, argv in (
                ("battery", ["--versions", "0", "--log_dir",
                             written["jax"][0], "--results_dir", results,
                             "--n_samples", str(EVAL_SAMPLES)]),
                ("targeted", ["--run", "--versions", "0", "--log_dir",
                              written["jax"][0], "--data_dir",
                              cfg.data.data_dir, "--results_dir",
                              os.path.join(results, "targeted")])):
            if path_name == "targeted":
                n_clips = _targeted_eval_sets(cfg.data.data_dir, cfg, rng)
            kept = _patch(wav2vec2, "mha_attention",
                          _kept_inputs(inputs[path_name], "attention"))
            random.seed(0)  # the jittered windows (global random)
            record.update(batches=0, forward_s=0.0, cache=[])
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            level = logging.getLogger().level  # the CLIs set INFO
            try:
                main = evaluate.main if path_name == "battery" \
                    else targeted_eval.main
                main(argv)
                torch.cuda.synchronize()
            finally:
                kept()
                logging.getLogger().setLevel(level)
            stats[f"{path_name}_s"] = time.perf_counter() - t0
            launches = _counts()
            stats[f"{path_name}_batches"] = record["batches"]
            stats[f"{path_name}_forward_s"] = record["forward_s"]
            stats[f"{path_name}_cache_s"] = sum(record["cache"])
            report["launches"][path_name] = launches
            want_launches = {"attention_fwd": n_layers * record["batches"],
                             "attention_bwd": 0, "triplet_loss": 0}
            if launches != want_launches or record["plain"]:
                raise AssertionError(f"{path_name} launches {launches} != "
                                     f"{want_launches}; plain "
                                     f"{record['plain']}")
            print(f"evaluation: {path_name} in {stats[path_name + '_s']:.1f}"
                  f" s: {record['batches']} batches, their forwards "
                  f"{record['forward_s']:.1f} s; item caches built "
                  f"({len(record['cache'])} checked) "
                  f"{sum(record['cache']):.1f} s; launches {launches}; "
                  f"plain versions on the card {record['plain']}")

        rows = torch.load(os.path.join(results, "full_scores_v0.pt"),
                          weights_only=False)
        stats["battery_rows"] = []
        for row in rows:
            summary = {
                "fragment_type": row["fragment_type"],
                "scrambled_video": row["scrambled_video"],
                "triplet_acc": float(row["triplet_acc"].mean()),
                "recall_at_10_fixed": float(row["recall_at_10_fixed"].mean()),
                "recall_at_10_jitter": float(
                    row["recall_at_10_jitter"].mean()),
                "size": int(row["recall_fixed"].shape[2])}
            for k in ("triplet_acc", "recall_fixed", "recall_jitter"):
                x = row[k]
                if not (isinstance(x, np.ndarray) and x.shape[0] == EVAL_SAMPLES
                        and np.isfinite(x).all() and (x >= 0).all()
                        and (x <= 1).all()):
                    raise AssertionError(f"battery row {summary}: {k}")
            print(f"evaluation: battery {summary}")
            stats["battery_rows"].append(summary)
        if len(rows) != 4 or any(r["recall_fixed"].shape[1] != 11
                                 for r in rows):
            raise AssertionError(f"battery rows {len(rows)}")
        with open(os.path.join(results, "targeted", "version_0",
                               "minimal_pairs_scores.csv")) as f:
            table = list(csv.DictReader(f))
        if len(table) != 2 * n_clips:
            raise AssertionError(f"targeted rows {len(table)} != "
                                 f"{2 * n_clips}")
        stats["targeted_clips"] = n_clips
        stats["targeted_acc"] = {}
        for scrambled in ("False", "True"):
            scores = [float(r["result"]) for r in table
                      if r["scrambled_video"] == scrambled]
            stats["targeted_acc"][scrambled] = float(np.mean(scores))
        print(f"evaluation: targeted triplets, {n_clips} clips of "
              f"{len(TARGETED_POS) * TARGETED_PAIRS} minimal pairs: mean "
              f"accuracy {stats['targeted_acc']} (scrambled video or not)")

        # one full-width video encode of each further tower
        stats["tower_ms"] = {}
        _reset_counts()
        for name, video in (("static", {"static": True}),
                            ("r3d_18", {"version": "r3d_18"}),
                            ("mc3_18", {"version": "mc3_18"})):
            variant = default_config()
            for k, v in video.items():
                setattr(variant.video, k, v)
            ms, norm_err = _tower_ms(variant, rng)
            stats["tower_ms"][name] = ms
            print(f"evaluation: {name} video tower, B={TOWER_B} "
                  f"{TOWER_SECONDS} s clips ({variant.training.precision}): "
                  f"{ms:.2f} ms; max |norm - 1| {norm_err:.2g} ({card})")
            if not norm_err <= 1e-2:
                raise AssertionError(f"{name} embeddings not unit norm")
        report["launches"]["towers"] = _counts()
        if any(report["launches"]["towers"].values()):
            raise AssertionError(f"towers launched {_counts()}")
    finally:
        for u in undo:
            u()
    # kernel 1 against its plain version at each path's first shape and
    # its longest
    held = {}
    for path_name, kept in inputs.items():
        if not kept:
            raise AssertionError(f"{path_name}: attention kept no inputs")
        keys = list(kept)
        for key in {keys[0], max(keys, key=lambda k: k[1][1])}:  # (B,T,H,hd)
            held[key] = kept[key]
    _hold_path_shapes(report, held, "evaluation_shapes",
                      kernels=("attention",))
    report["evaluation"] = stats


# ------------------------------------------------------------------ phase 5
def card_vs_cpu() -> None:
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = default_config()
    cfg.training.precision = "fp32"
    rng = np.random.default_rng(1)
    batch = _clip_batch(rng, cfg, 1, 2.3)
    out = {}
    for device in ("cuda", "cpu"):
        model = init_model(cfg, seed=0, device=device)
        with torch.inference_mode():
            a = model.encode_audio(torch.from_numpy(batch.audio).to(device))
            v = model.encode_video(torch.from_numpy(batch.video).to(device))
        out[device] = (a.cpu().numpy(), v.cpu().numpy())
        del model
    for i, name in enumerate(("audio", "video")):
        err = float(np.abs(out["cuda"][i] - out["cpu"][i]).max())
        print(f"card vs CPU, float32 {name} embedding: max|d|={err:.3g} "
              f"(tol {EMB_TOL})")
        if not err <= EMB_TOL:
            raise AssertionError(f"{name} embedding card vs CPU: {err}")


def card_vs_cpu_train() -> None:
    """One float32 training micro-step, full width, 2 layers, B=2,
    `audio.dropout: 0.0`, on the card (kernels) and the CPU (plain
    versions): the loss within rtol 1e-4, and the gradients as
    tests/test_torch_port_train_step.py holds them (train-mode R(2+1)D-18
    is chaotic in float32, so the video tower's by norm)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = default_config()
    cfg.training.precision = "fp32"
    cfg.audio.num_layers = 2
    cfg.audio.dropout = 0.0
    batch = _clip_batch(np.random.default_rng(3), cfg, 2, TRAIN_SECONDS)
    out = {}
    for device in ("cuda", "cpu"):
        model = init_model(cfg, seed=0, device=device)
        state, m = train_step(TrainState.create(model, cfg), batch, seed=0,
                              device=device)
        out[device] = (m["train_loss"].item(),
                       {n: g.cpu() for n, g in state.acc_grads.items()})
        del state, model
    (card_loss, card_g), (cpu_loss, cpu_g) = out["cuda"], out["cpu"]
    print(f"card vs CPU, float32 train micro-step: loss {card_loss:.8f} vs "
          f"{cpu_loss:.8f}")
    if not abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss):
        raise AssertionError(f"train loss card {card_loss} vs CPU {cpu_loss}")
    # each tensor's difference over what its tolerance allows (<= 1 passes)
    worst = {"audio": (0.0, ""), "video": (0.0, "")}
    for name, want in cpu_g.items():
        d = card_g[name] - want
        if name.startswith("video_encoder."):
            tower = "video"
            used = (d.norm() / (0.1 * want.norm() + 1e-8)).item()
        else:
            tower = "audio"
            used = (d.abs().max()
                    / (1e-3 * want.abs().max() + 1e-8)).item()
        worst[tower] = max(worst[tower], (used, name))
        if not used <= 1.0:
            raise AssertionError(f"gradient {name} card vs CPU: {used:.3g} "
                                 "of its tolerance")
    print(f"card vs CPU, float32 gradients ({len(cpu_g)} tensors), worst "
          "share of the tolerance used: audio (max|d| <= 1e-3 max|g| + 1e-8) "
          f"{worst['audio'][0]:.3g} at {worst['audio'][1]}, video (|d| <= "
          f"0.1 |g| + 1e-8) {worst['video'][0]:.3g} at {worst['video'][1]}")


# ------------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "peppa_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from peppa_tpu_torch.ops.cuda import build

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"into {build.build_dir()}")
    for name, log in build.build_log.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")

    phases = ((2, lambda: (print_kernel_resources(),
                           check_attention(report),
                           check_attention_bwd(report),
                           check_loss(report))),
              (3, lambda: run_slice(report, card)),
              ("4a", lambda: run_training(report, card, True)),
              ("4b", lambda: run_training(report, card, False)),
              ("4c", lambda: run_trainer(report, card)),
              ("4d", lambda: run_pipeline(report, card, root)),
              (6, lambda: run_evaluation(report, card, root)),
              (5, lambda: (card_vs_cpu(), card_vs_cpu_train())))
    report: dict = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")  # 4d's tree, for 6
    try:
        for phase, fn in phases:
            t0 = time.perf_counter()
            fn()
            print(f"phase {phase} done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"chip_smoke: every phase done in "
          f"{time.perf_counter() - T_START:.1f} s in all")

    paths = report["launches"]  # path -> kernel -> launches
    kernels = []
    for name, replaces, source_report in (
            ("attention_fwd", "peppa_tpu/ops/pallas/attention.py:123",
             "attention"),
            ("attention_bwd", "peppa_tpu/ops/pallas/attention.py:137",
             "attention_bwd"),
            ("triplet_loss", "peppa_tpu/ops/pallas/loss.py:62",
             "triplet_loss")):
        by_path = {path: counts[name] for path, counts in paths.items()}
        source = ("peppa_tpu_torch/csrc/loss.cu" if name.startswith("triplet")
                  else "peppa_tpu_torch/csrc/attention.cu")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **report[source_report]})
    print(json.dumps({"kernels": kernels}))
    train = {tag: {k: v for k, v in report[tag].items() if k != "losses"}
             for tag in ("train_deterministic", "train_default")}
    print(json.dumps({"encode_pairs_per_s": report["encode_pairs_per_s"],
                      "batch": 32, "bucket_s": 2.3,
                      "audio_tower_ms_6s": report["audio_tower_ms_6s"],
                      **train,
                      "train_batch": TRAIN_B, "train_clip_s": TRAIN_SECONDS,
                      "trainer": report["trainer"],
                      "pipeline": report["pipeline"],
                      "evaluation": report["evaluation"],
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
