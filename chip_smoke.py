#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`peppa_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # one card, no arguments
    python3 chip_smoke.py --phases 7 # some phases (and what they read)

Phases:
  1. the card's name and power limit; build the CUDA kernels from
     `peppa_tpu_torch/csrc/` (seconds printed);
  2. the registers and spill bytes (`ptxas -v`) of the bf16 attention
     kernels (forward, backward dq and dkdv), the float32 forward and its
     combine kernel, the float32 backward's dq and dkdv kernels, and the
     loss kernels; each
     kernel against its plain PyTorch version on the card, at the main
     paths' shapes, with its time, the plain version's and a library
     yardstick's: the attention forward (serving shapes, T=316 and 826;
     float32 at B=32 and at phase 4e's B=8 (two key splits), T=316, also
     replayed from a CUDA graph beside SDPA, with the share of its bound),
     the attention backward (training shapes, B=8, T=316 and 826, bf16 and
     float32, and float32 at phase 5's B=2, T=316; it and SDPA's backward
     as the median of 7 timings, with their spread, and replayed from a
     CUDA graph, with the share of its bound), the
     triplet loss alone and with its gradient (B = 8, 13, 32, 1024 and two
     mixed-activity cases; timed at B = 8 and 32 back-to-back and replayed
     from a CUDA graph, with `torch.profiler`'s kernel times beside);
  3. the serving/eval forward of the base configuration (`hparams_base.yaml`:
     wav2vec2-base + R(2+1)D-18, bf16) at full width from seeded random
     weights: `EncoderService` warm-up and mixed-length requests over every
     bucket, then `eval_step` on a B=32 2.3 s batch; then the encode time
     of both towers at B=32 on the 2.3 s bucket and of the audio tower
     alone on the 6.0 s bucket (T=826);
 3q. W8A8 int8 serving of the same configuration and weights: the run
     directory written as the JAX package's msgpack and served by
     `EncoderService.from_checkpoint(..., quantize_int8=True)` (warm-up
     over every bucket, the mixed-length requests, `eval_step` at B=32,
     2.3 s): kernel 1 12 times and 79 int8 products (`ops/quant.py`'s
     counters) per audio forward, 37 per video forward, kernel 3 once;
     each int8 product (a library call: im2col + `torch._int_mm`, no TPU
     kernel) on the path's first input of each weight shape, row 0, equal
     bit for bit to its plain version on the CPU (the int32 accumulator and
     the dequantised output); the cosine of the int8 embeddings to the
     bf16 float path's (above 0.99); encode pairs/s at B=32, 2.3 s, and the
     audio tower at B=32, 6.0 s, int8 and bf16 in turns, with the peak
     memory; a `torch.profiler` split of one int8 encode (quantize passes,
     im2col copies, int8 GEMMs, dequantize, the rest); one float32 int8
     2.3 s pair on the card and the CPU, each product on the card fed the
     CPU's input (as tests/test_torch_port_quant.py holds the port to the
     JAX package);
 3x. the deployment path on the same configuration and weights: `python
     -m peppa_tpu_torch.export` on 3q's run directory (weight-free
     `torch.export` programs of both towers at every bucket, B=32, and the
     weights once), beside it `python -m peppa_tpu_torch.example` over
     three 44.1 kHz WAV files and the W8A8 towers' export at 2.3 s (three
     processes at once on the host's cores); each program's export
     seconds and bytes, 12 `peppa_tpu_torch.mha_attention` nodes and no
     einsum in each audio graph, 79 / 37 `aten._int_mm` nodes in the int8
     audio / video graphs; a second process (`--serve_artifacts`, JAX
     blocked, no model code imported) that loads the artifacts with
     `ExportedEncoders` and serves phase 3's requests (the int8 artifact
     those of the 2.3 s bucket): embeddings equal bit for bit to the live
     `EncoderService`s', kernel 1 12 times per audio program call, no plain
     version on the card, then kernel 1 against its plain version on the
     path's first input, and the host time to issue it through the custom
     op; each artifact's load seconds and peak memory; encode pairs/s at
     B=32, 2.3 s, artifact and live in turns;
  4. the training step of the same configuration at full width and depth,
     bf16, micro-batch 8 of 2.3 s clips, `accumulate_grad_batches` 8, for 2
     optimizer steps (16 micro-steps), twice: (a) `audio.dropout: 0.0`,
     every attention through the forward and backward kernels; (b) the
     defaults (dropout 0.1, layer-drop 0.05), attention on the JAX
     package's own plain route, and the first micro-steps run again from
     the same seed to show the run is reproducible; each timed as the
     host-clock mean over micro-steps 2-16 and as the median of their
     CUDA-event times;
 4e. the same 16 micro-steps in float32 (`training.precision: fp32`) with
     `audio.dropout: 0.0`: every attention through the float32 forward and
     backward kernels (192 launches each), timed as 4a, with the TF32
     settings in force; then kernel 1's float32 route run again on the
     path's first inputs and the output and log-sum-exp the path saved for
     its first backward, each against the plain version, and kernel 2's on
     that backward's inputs: with the path's dO (within 1e-4 of the
     largest |plain| gradient, each beside the plain version's error
     against float64) and with a unit-scale dO;
 4p. data-parallel training over `torch.distributed`: (a) 4a's
     configuration and batches with k = 2 for 4 micro-steps, in this
     process alone and then through the distributed code path over NCCL
     at world size 1 (`init_distributed`, `make_mesh`, the gradient
     all-reduce): the same losses and state bit for bit, and the losses
     4a's first four; (b) two rank processes sharing the card over gloo
     on CUDA tensors (NCCL refuses two ranks on one device), float32,
     `audio.dropout: 0.0`, full width and depth, micro-batch 4 of 2.3 s
     a rank, k = 2, 4 micro-steps: kernels 1 and 2 12 times a micro-step
     on each rank, kernel 3 none (the global-negative loss), no plain
     version on the card; rank 0 holds kernel 1's float32 route (3 key
     splits at B=4) and kernel 2's on the first inputs its two-rank run
     gave them, as 4e does, and then takes the same steps in one process
     on the 8-row global batches: the losses within rtol 1e-4, the
     gradient handed to BertAdam and the parameters after each optimizer
     step at phase 5's tolerances, the running statistics; each rank's ms
     per micro-step and peak memory (two ranks on one card measure
     correctness and overhead, not scaling);
 4r. `tpu.remat_audio` and `remat_video` (`torch.utils.checkpoint` of the
     towers): 4a's configuration, batches and 16 micro-steps with both
     flags and without, with `audio.dropout: 0.0` (kernel 1 24 times a
     micro-step under remat against 12, kernel 2 12, kernel 3 once) and
     with the defaults (dropout and layer-drop, whose masks the recompute
     must draw again), then the static tower (k = 2, 4 micro-steps), all
     with cuDNN's deterministic algorithms: the losses, the gradients
     handed to BertAdam and the final state (parameters, running
     statistics, moments) bit for bit against the run without remat; each
     run's peak memory (remat at least 1 GiB lower) and CUDA-event median
     ms per micro-step of micro-steps 2-16;
 4s. the trainer's profile window: a short `Trainer.fit` of 4a's
     configuration with PEPPA_PROFILE_DIR and PEPPA_PROFILE_STEPS=2 writes
     one trace that parses, with two `train_step` ranges and kernels 1 and
     3 by name; then the seven-condition ablation sweep
     (`peppa_tpu_torch/ablation_sweep.py::run_sweep`) at full width
     (180x100 at 10 fps, 44.1 kHz, bf16, each condition's towers) on a
     small synthetic tree (dialog train 1-4, dialog val 197-198,
     narration val 1-2, two 7 s clips each): batches of 4, 3 micro-steps
     and one validation batch a loader per fit, no sanity validation, k =
     1, 20 bootstrap subsets; each fit's seconds and launches, the
     scoring's, 7 distinct versions in conditions.yaml, the 28 rows of
     scores.csv and both tables, no plain version on the card, then
     kernels 1 and 3 against their plain versions on the first inputs of
     each shape the sweep gave them;
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
  7. the results path (after 6, on its run directories and score files):
     a realign tree of 40 utterances of 1-4 s as 44.1 kHz WAV with
     gentle-style word spans, phones and speakers written under 4d's tree,
     narration test episodes added, a static and a float32 run directory
     beside 6's; then each step whose host packages are installed
     (RESULTS_STEPS; the others are named with the missing package):
     `grsa.Embedder`'s five stages (kernel 1: 12 launches a batch on the
     untrained, trained, project and context stages, none on conv), the
     float32 Embedder on the card against the CPU, `grsa.main` or
     `pairwise` of the multiword utterances, `embed_utterances`,
     `unpairwise`, `stats.main`, `word_type`, `vanilla_rsa`, `probe`,
     `duration_effect` and `duration_effect_scramble` (the pretraining_a,
     static and base runs of a conditions.yaml), `test_run`, and the
     tables and figures (`merge_scores`, `format_tables`, `test_table`,
     `plots`, `recall_at_1_to_n_plot`, `duration_effect_plot`, the
     targeted CLI's `--plot`); each step's seconds; kernel 1 against its
     plain version on every shape the phase gave it;
  8. the corpus-preparation path on raw episodes it writes under $TMPDIR
     in the reference's `data/in` layout (narration val 1-4 and dialog val
     197-200, 60 s each, 240x136 at 25 fps, mpeg4 + 44.1 kHz PCM .avi, 12
     subtitle lines each of a template grammar): `PigData.prepare_data`
     with `data.extract` (the 180x100 tree), `realign` of every val line
     with the port's wav2vec2-base CTC model (float32, seeded, full width
     and depth) on the card from a pool of one thread per core (kernel 1:
     12 launches per utterance, with key lengths, at T = 99, 199, 399,
     799; kernel 3 none; no plain version on the card), `extract_realines`,
     the eval sets through `python -m peppa_tpu_torch.generate_eval_sets`,
     `targeted_eval --run` on them with a seeded base run directory, and
     human_check's exports whose host packages are installed (PREP_STEPS);
     then the CTC log-probs of one utterance in each of the 2, 4 and 8 s
     buckets on the card against the CPU (float32, 1e-4) with equal
     alignments, the native DP against the Python DP bit for bit, realign
     with 1 and 8 threads writing the same bytes, kernel 1 against its
     plain version on every shape of the phase, and kernel 1 in float32
     timed at the aligner's shapes (B=1, one key short of T), back-to-back
     and replayed from a CUDA graph, with its plain version, SDPA (both
     ways) and its bound;
  5. the same weights in float32 on the card (kernels) and on the CPU (plain
     versions): the serving embeddings of one 2.3 s pair, and one training
     micro-step (2 layers, B=2, `audio.dropout: 0.0`): loss and gradients;
then one JSON line of per-kernel numbers, one of the serving, training,
evaluation, results and preparation metrics, the card's name and power
limit, and the
last line `{"ok": true, "device": {...}}`.  With `--phases`, only those
phases run (phase 6 writes 4d's episode tree when 4d does not run; phase
7 brings phase 6), and the summary is their records.

Launch counts are set to 0 just before each main path (3, 3q, 3x's artifact
serving in its own process, 4a, 4b, 4e, 4p's world-size-1 run and each
rank's two-rank run (the ranks report theirs), each of 4r's runs, 4s's
profiled fit, each of its seven fits and its scoring, the
fit and the resumed fit of 4c, the fit and the scorer of 4d, the loads,
the battery, the targeted path and the towers of 6, each model step of
7, the realign and the targeted path of 8) and read just after it.

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


def tf32_line() -> str:
    """The TF32 settings in force in this process."""
    import torch

    return (f"TF32 in force: matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn {torch.backends.cudnn.allow_tf32}")


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


def graph_ms(fn, calls: int = 10, replays: int = 20, stream=None) -> float:
    """Device time of one `fn()`: `calls` calls captured once in a CUDA
    graph, replayed `replays` times between two CUDA events, so no host
    work sits between the kernels.  `stream`: the stream to warm up and
    capture on (autograd runs a backward on its forward's stream, so a
    backward alone is captured on the stream its forward ran on)."""
    import torch

    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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
    ("attention", r"(attention_fwd_f32(?:_combine)?_kernel)"
                  r"ILi(\d+)ELb([01])E", "{0}<hd {1}, vec {2}>"),
    ("attention", r"(attention_bwd_(?:dq|dkdv)_f32_kernel)"
                  r"ILi(\d+)ELb([01])E", "{0}<hd {1}, vec {2}>"),
    ("loss", r"(loss_cluster_kernel)ILi(\d)ELb([01])E", "{0}<R {1}, grad {2}>"),
    ("loss", r"(loss_tiles_kernel)ILb([01])E", "{0}<grad {1}>"),
    ("loss", r"(loss_(?:rows|grad)_kernel)", "{0}"),
)


def print_kernel_resources() -> None:
    """Registers and spill bytes of each bf16 attention kernel
    instantiation (forward, backward dq and dkdv; head dim, vector path),
    of the float32 forward and its combine kernel, of the float32
    backward's dq and dkdv kernels, and of each loss kernel, from `ptxas
    -v` in this process's build."""
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


def f32_attention_times(b: int, t: int, length) -> dict:
    """Kernel 1 in float32 at (b, t, 12, 64) with key length `length` for
    every example (None: all t): held against its plain version, then
    timed back-to-back (`time_ms`, the host's launch cost included) and
    replayed from a CUDA graph (`graph_ms`, device time), beside SDPA on
    the same inputs (a boolean key mask where there are lengths) timed
    both ways and the plain version; with the bound and the share of it
    reached in device time."""
    import torch
    import torch.nn.functional as F

    from peppa_tpu_torch.ops.cuda.attention import (_f32_plan, mha_attention,
                                                    mha_attention_plain)

    h, hd = 12, 64
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(b, t, h, hd, generator=gen, device="cuda")
               for _ in range(3))
    lengths = mask = None
    if length is not None:
        lengths = torch.full((b,), length, dtype=torch.int32, device="cuda")
        mask = (torch.arange(t, device="cuda") < lengths[:, None])[
            :, None, None, :]
    err = (mha_attention(q, k, v, lengths)
           - mha_attention_plain(q, k, v, lengths)).abs().max().item()
    if not err <= TOL_ATTN["float32"]:
        raise AssertionError(f"attention float32 B={b} T={t}: {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kernel():
        mha_attention(q, k, v, lengths)

    def sdpa():
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    n_keys = t if length is None else length
    bms, by = bound(4 * b * t * h * hd * 4 + (0 if length is None else 4 * b),
                    4 * b * h * t * n_keys * hd, "float32")
    row = {"B": b, "T": t, "dtype": "float32", "length": length,
           "key_splits": _f32_plan(b, h, t)[1], "ms": time_ms(kernel), "device_ms": graph_ms(kernel),
           "plain_ms": time_ms(lambda: mha_attention_plain(q, k, v, lengths),
                               iters=5),
           "library_ms": time_ms(sdpa), "library_device_ms": graph_ms(sdpa),
           "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    row["bound_share"] = bms / row["device_ms"]
    print(f"attention float32 B={b} T={t} (length {length}, "
          f"{row['key_splits']} key splits): kernel "
          f"{row['ms']:.4f} ms back-to-back, {row['device_ms']:.4f} ms "
          f"device; sdpa {row['library_ms']:.4f} / "
          f"{row['library_device_ms']:.4f} ms; plain {row['plain_ms']:.4f} "
          f"ms; bound {bms:.4f} ms ({by}), {row['bound_share']:.1%} of it "
          f"in device time; max|d|={err:.3g} (tol {TOL_ATTN['float32']})")
    return row


def _bwd_error(got, want, what: str, atol=None) -> float:
    """max |kernel - plain| over kernel 2's dq, dk, dv; prints each and
    raises where an element is off by more than atol + tol|plain| (tol
    from TOL_ATTN_BWD for their dtype; atol: tol unless given)."""
    err = 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        tol = TOL_ATTN_BWD[str(w.dtype).split(".")[1]]
        d = (g.float() - w.float()).abs()
        near = tol if atol is None else atol
        err = max(err, d.max().item())
        print(f"attention bwd {what} {gname}: max|d|={d.max().item():.3g} "
              f"(tol {near:.3g} + {tol}|plain|)")
        if not bool((d <= near + tol * w.float().abs()).all()):
            raise AssertionError(f"attention bwd {what} {gname}: "
                                 f"{d.max().item()}")
    return err


def _check_bwd(q, k, v, do, lengths, what: str) -> float:
    """Kernel 2 on the forward kernel's output and log-sum-exp against its
    plain version (`_bwd_error`)."""
    from peppa_tpu_torch.ops.cuda.attention import (_launch,
                                                    mha_attention_bwd,
                                                    mha_attention_bwd_plain)

    scale = q.shape[-1] ** -0.5
    out, lse = _launch(q, k, v, lengths, scale, with_lse=True)
    return _bwd_error(mha_attention_bwd(q, k, v, do, lengths, scale, lse, out),
                      mha_attention_bwd_plain(q, k, v, do, lengths, scale),
                      what)


def attention_bwd_times(q, k, v, do, err: float) -> dict:
    """Kernel 2 at the training path's call (no key lengths) on (B, T, 12,
    64) q, k, v, dO already held against its plain version (`err`), fed by
    the forward kernel's output and log-sum-exp: the median of 7
    back-to-back readings (`median_ms`, the host's launch cost included)
    with their range, and replayed from a CUDA graph (`graph_ms`, device
    time), beside SDPA's backward on the same inputs timed both ways (its
    back-to-back readings spread) and the plain version; with the bound
    and the share of it reached in device time."""
    import torch
    import torch.nn.functional as F

    from peppa_tpu_torch.ops.cuda.attention import (_launch,
                                                    mha_attention_bwd,
                                                    mha_attention_bwd_plain)

    b, t, h, hd = q.shape
    name = str(q.dtype).split(".")[1]
    scale = hd ** -0.5
    out, lse = _launch(q, k, v, None, scale, with_lse=True)

    def kernel():
        mha_attention_bwd(q, k, v, do, None, scale, lse, out)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    fwd = F.scaled_dot_product_attention(qt, kt, vt)
    # a forward whose backward can be captured: its leaves and their
    # autograd nodes made on the capture stream, so nothing in the
    # backward waits on the default stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
        fwd_side = F.scaled_dot_product_attention(*leaves)
    torch.cuda.current_stream().wait_stream(side)

    # q, k, v, dO in and dQ, dK, dV out; five products of T^2 hd
    bms, by = bound(7 * b * t * h * hd * q.element_size(),
                    10 * b * h * t * t * hd, name)
    ms, lo, hi = median_ms(kernel)
    lib_ms, lib_lo, lib_hi = median_ms(lambda: torch.autograd.grad(
        fwd, (qt, kt, vt), dot, retain_graph=True))
    row = {"B": b, "T": t, "dtype": name,
           "ms": ms, "ms_range": [lo, hi], "device_ms": graph_ms(kernel),
           "plain_ms": time_ms(lambda: mha_attention_bwd_plain(
               q, k, v, do, None, scale), iters=5),
           "library_ms": lib_ms, "library_ms_range": [lib_lo, lib_hi],
           "library_device_ms": graph_ms(lambda: torch.autograd.grad(
               fwd_side, leaves, dot, retain_graph=True), stream=side),
           "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    row["bound_share"] = bms / row["device_ms"]
    print(f"attention bwd {name} B={b} T={t}: kernel {ms:.4f} ms "
          f"back-to-back ({lo:.4f}-{hi:.4f}), {row['device_ms']:.4f} ms "
          f"device; sdpa backward {lib_ms:.4f} ({lib_lo:.4f}-{lib_hi:.4f}) "
          f"/ {row['library_device_ms']:.4f} ms; plain {row['plain_ms']:.4f} "
          f"ms; bound {bms:.4f} ms ({by}), {row['bound_share']:.1%} of it "
          f"in device time")
    return row


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
                rows.append({"B": b, "T": t, "dtype": name, "ms": ms,
                             "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bms, "bound_by": by})
            elif t == 316:  # the float32 Embedder's call (phase 7), and
                # float32 training's (phase 4e: two key splits at B=8)
                rows.append({**f32_attention_times(b, t, None),
                             "path": "results_embedder_f32"})
                rows.append({**f32_attention_times(TRAIN_B, t, None),
                             "path": "train_f32"})
    # the kernel's line: T=316 (the 2.3 s bucket), with the rest beside it
    report["attention"] = {**{k: v for k, v in rows[0].items() if k != "T"},
                           "max_abs_err": worst, "shapes": rows}


def check_attention_bwd(report: dict) -> None:
    import torch

    b, h, hd = TRAIN_B, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    rows = []  # at each T: bf16, then float32 (phase 4e's call at T=316)
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
            err = max(_check_bwd(q, k, v, do, lengths, f"T={t} {name} {tag}")
                      for lengths, tag in ((None, "full"), (ragged, "ragged")))
            row = attention_bwd_times(q, k, v, do, err)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            else:
                row["path"] = "train_f32"
            rows.append(row)
    # float32 at phase 5's card-vs-CPU micro-step (B=2: 120 blocks a grid)
    q, k, v, do = (torch.randn(2, 316, h, hd, generator=gen, device="cuda")
                   for _ in range(4))
    err = _check_bwd(q, k, v, do, None, "B=2 T=316 float32 full")
    rows.append({**attention_bwd_times(q, k, v, do, err),
                 "path": "card_vs_cpu"})
    report["attention_bwd"] = {
        **{k: v for k, v in rows[0].items() if k not in ("B", "T", "dtype")},
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
    report["launches"]["serve"] = launches

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


# ----------------------------------------------------------------- phase 3q
INT8_COS = 0.99  # int8 against float embeddings, tests/test_quant.py's bound
# int8 products per forward of the base towers: wav2vec2-base conv1-6, proj
# and 6 in each of its 12 layers; R(2+1)D-18's 37 trunk convs
INT8_PER_AUDIO = {"int8_conv": 6, "int8_matmul": 1 + 6 * 12}
INT8_PER_VIDEO = {"int8_conv": 37, "int8_matmul": 0}
# tests/test_torch_port_quant.py: each product fed the other side's input,
# the own input within INT8_GLUE_TOL of it (share of its largest |value|),
# the embeddings within INT8_TOL
INT8_GLUE_TOL, INT8_TOL = 1e-5, 1e-6
# the quantization steps that phase 3q's profile splits out
INT8_PARTS = {"quantize": ("absmax_weight_scale", "act_scale",
                           "quantize_int8"),
              "im2col": ("_im2col",), "int8 GEMM": ("_int_mm_padded",),
              "dequantize": ("dequantize",)}


def _int8_counts(reset: bool = False) -> dict:
    from peppa_tpu_torch.ops import quant

    out = {"int8_conv": quant.int8_conv.calls,
           "int8_matmul": quant.int8_matmul.calls}
    if reset:
        quant.int8_conv.calls = quant.int8_matmul.calls = 0
    return out


def _wrap_int8(wrapper):
    """Wrap the int8 entry points as `models/layers.py` calls them; returns
    the undo."""
    from peppa_tpu_torch.models import layers

    undos = [_patch(layers, "int8_conv", lambda real: wrapper(real, "conv")),
             _patch(layers, "int8_matmul",
                    lambda real: wrapper(real, "matmul"))]
    return lambda: [undo() for undo in undos]


def _keep_int8(kept: dict):
    """A wrapper that keeps the first input of each int8 product's weight
    shape, stride and padding (on the host) and row 0 of its output."""
    def wrapper(real, kind):
        def run(x, w, *args):
            y = real(x, w, *args)
            key = (kind, tuple(w.shape), *[tuple(a) for a in args
                                           if isinstance(a, tuple)])
            if key not in kept:
                kept[key] = (x.detach().cpu(), w.detach().cpu(), args,
                             y[:1].cpu())
            return y
        return run
    return wrapper


def _equal(a, b) -> bool:
    """Same shape, dtype and values (strides aside)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _hold_int8(kept: dict) -> int:
    """Each kept product on row 0 of its input, quantized with the whole
    input's scale: the int32 accumulator of the card route (`_int_mm` on
    the card) equal to the plain version's on the CPU, and the path's
    dequantised output equal to the plain version's, bit for bit."""
    from peppa_tpu_torch.ops import quant

    for (kind, *shape), (x, w, args, y0) in kept.items():
        w_scale = quant.absmax_weight_scale(w)
        wq = quant.quantize_int8(w, w_scale)
        s_x = quant.act_scale(x)  # the whole input's
        xq = quant.quantize_int8(x[:1], s_x)
        if kind == "conv":
            stride, padding, out_dtype = args
            acc = quant.conv_acc_plain(xq, wq, stride, padding)
            card = quant.conv_acc_mm(xq.cuda(), wq.cuda(), stride, padding)
            scale = (s_x * w_scale.reshape(-1)).view(
                -1, *([1] * (w.ndim - 2)))
        else:
            (out_dtype,) = args
            acc = quant.matmul_acc_plain(xq, wq)
            card = quant.matmul_acc_mm(xq.cuda(), wq.cuda())
            scale = s_x * w_scale.reshape(-1)
        y = quant.dequantize(acc, scale, out_dtype)
        if not (_equal(card.cpu(), acc) and _equal(y0, y)):
            raise AssertionError(f"int8 {kind} {shape} x {tuple(x.shape)}: "
                                 "card and plain versions differ")
    return len(kept)


def _int8_f32_card_vs_cpu() -> dict:
    """One 2.3 s pair through the float32 int8 towers on the CPU (plain
    versions) and on the card, as tests/test_torch_port_quant.py holds the
    port to the JAX package: each product on the card fed the CPU's input,
    its own input within INT8_GLUE_TOL of it, its output equal to the
    CPU's; the embeddings within INT8_TOL.  Then the card on its own (the
    int8 rounding ties make that difference larger; printed)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model

    cfg = default_config()
    cfg.training.precision = "fp32"
    cfg.tpu.quantize_int8 = True
    batch = _clip_batch(np.random.default_rng(4), cfg, 1, 2.3)
    calls, fed = [], {"n": 0, "glue": 0.0, "unequal": 0}

    def record(real, kind):
        def run(x, w, *args):
            y = real(x, w, *args)
            calls.append((x.clone(), y.clone()))
            return y
        return run

    def feed(real, kind):
        def run(x, w, *args):
            x_cpu, y_cpu = calls[fed["n"]]
            fed["n"] += 1
            glue = float((x.cpu() - x_cpu).abs().max() / x_cpu.abs().max())
            fed["glue"] = max(fed["glue"], glue)
            y = real(x_cpu.cuda(), w, *args)
            fed["unequal"] += not _equal(y.cpu(), y_cpu)
            return y
        return run

    def encode(model, device):
        with torch.inference_mode():
            return (model.encode_audio(torch.from_numpy(batch.audio)
                                       .to(device)).cpu(),
                    model.encode_video(torch.from_numpy(batch.video)
                                       .to(device)).cpu())

    undo = _wrap_int8(record)
    try:
        want = encode(init_model(cfg, seed=0, device="cpu"), "cpu")
    finally:
        undo()
    card = init_model(cfg, seed=0)
    undo = _wrap_int8(feed)
    try:
        got = encode(card, "cuda")
    finally:
        undo()
    free = encode(card, "cuda")
    out = {"products": fed["n"], "glue": fed["glue"],
           "unequal_products": fed["unequal"],
           "max_abs": max(float((g - w).abs().max())
                          for g, w in zip(got, want)),
           "free_running_max_abs": max(float((g - w).abs().max())
                                       for g, w in zip(free, want))}
    print(f"int8 serving, float32 2.3 s pair card vs CPU: {out['products']} "
          f"products fed the CPU's inputs, own inputs within "
          f"{out['glue']:.3g} (tol {INT8_GLUE_TOL}), {out['unequal_products']} "
          f"unequal; embeddings max|d|={out['max_abs']:.3g} (tol {INT8_TOL});"
          f" left on its own {out['free_running_max_abs']:.3g} (not held: "
          f"rounding ties); {tf32_line()}")
    if (fed["n"] != len(calls) or fed["unequal"]
            or not out["glue"] <= INT8_GLUE_TOL
            or not out["max_abs"] <= INT8_TOL):
        raise AssertionError(f"int8 float32 card vs CPU: {out}")
    return out


def _int8_profile(model, audio, video) -> dict:
    """Device time of one int8 encode (B=32, 2.3 s) under `torch.profiler`,
    split by the quantization steps (`INT8_PARTS`, each wrapped in a
    `record_function` range here) and the rest (the float work)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from peppa_tpu_torch.ops import quant

    def ranged(name):
        def wrap(real):
            def run(*args, **kw):
                with record_function(f"int8.{name}"):
                    return real(*args, **kw)
            return run
        return wrap

    names = [n for part in INT8_PARTS.values() for n in part]
    undos = [_patch(quant, name, ranged(name)) for name in names]
    try:
        torch.cuda.synchronize()
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                as prof:
            model.encode_audio(audio)
            model.encode_video(video)
            torch.cuda.synchronize()
    finally:
        for undo in undos:
            undo()
    by_range = {}
    for e in prof.events():
        if e.name.startswith("int8.") and e.device_type == DeviceType.CPU:
            by_range[e.name[5:]] = (by_range.get(e.name[5:], 0.0)
                                    + e.device_time_total / 1e3)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.device_time_total for e in kernels) / 1e3
    split = {part: sum(by_range.get(n, 0.0) for n in members)
             for part, members in INT8_PARTS.items()}
    split["the rest (float work)"] = total - sum(split.values())
    print(f"int8 encode profile (B=32, 2.3 s): device kernel time "
          f"{total:.2f} ms; " + ", ".join(f"{k} {v:.2f} ms"
                                          for k, v in split.items()))
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in kernels[:12]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:5d}  "
              f"{e.key[:100]}")
    return {"device_ms": total, "split_ms": split}


def _msgpack_run(model, cfg, root: str) -> str:
    """`model` (phase 3's configuration and seeded weights) as a run
    directory of the JAX package's format (flax msgpack by the port's
    encoder, sidecar, hparams.yaml) under `root`, written once: phases 3q
    and 3x read it."""
    import numpy as np

    from peppa_tpu_torch.models.convert import export_jax_variables
    from peppa_tpu_torch.training.flax_msgpack import write_checkpoint

    vdir = os.path.join(root, "msgpack_run", "version_0")
    path = os.path.join(vdir, "checkpoints",
                        "epoch=0-valnarr_triplet=0.50.ckpt")
    if os.path.exists(path + ".json"):
        return vdir
    os.makedirs(os.path.dirname(path))
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    write_checkpoint(path, {"step": np.asarray(0, np.int32),
                            **export_jax_variables(model), "opt_state": {}})
    with open(path + ".json", "w") as f:
        json.dump(dict(RUN_META, best_model_path=path), f)
    return vdir


def run_slice_int8(report: dict, card: str, root: str) -> None:
    """W8A8 serving of phase 3's configuration and seeded weights: the run
    directory served by `EncoderService.from_checkpoint(...,
    quantize_int8=True)`, warm-up over every bucket, mixed-length requests
    and `eval_step`; the launches of kernels 1 and 3 and the int8 products
    per forward; each product held against its plain version on the path's
    first inputs of each weight shape; the embeddings against the bf16
    float path's; encode and audio-tower times beside bf16's (in turns);
    the profile split; a float32 int8 pair card vs CPU."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.serving import EncoderService
    from peppa_tpu_torch.training.step import eval_step
    from peppa_tpu_torch.utils.request_batching import group_by_bucket

    cfg = default_config()  # bf16, full width; the flag comes at serving
    model = init_model(cfg, seed=0)  # phase 3's weights
    vdir = _msgpack_run(model, cfg, root)
    svc = EncoderService.from_checkpoint(vdir, quantize_int8=True,
                                         batch_size=32)
    if not (svc.config.tpu.quantize_int8
            and svc.model.video_encoder.trunk.stem_spatial.quant):
        raise AssertionError("from_checkpoint(quantize_int8=True) built a "
                             "float model")
    rng = np.random.default_rng(0)
    waves, clips = _requests(rng, cfg, 40)
    batch = _clip_batch(rng, cfg, 32, 2.3)
    n_audio = len(svc.buckets) + _audio_batches(svc, waves) + 1
    groups = group_by_bucket(clips, lambda x: svc._video_bucket(x.shape[0]))
    n_video = len(svc.buckets) + sum(-(-len(i) // svc.batch_size)
                                     for i in groups.values()) + 1

    kept = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _int8_counts(reset=True)
    t0 = time.perf_counter()
    svc.warmup()
    undo = _wrap_int8(_keep_int8(kept))  # the first real inputs
    try:
        a = svc.embed_audio(waves)
        v = svc.embed_video(clips)
        ev, ea, loss = eval_step(svc.model, batch)
        torch.cuda.synchronize()
    finally:
        undo()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, products = _counts(), _int8_counts()
    print(f"int8 serving path: warmup + {len(waves)} audio + {len(clips)} "
          f"video requests + eval step in {elapsed:.1f} s; launches "
          f"{launches}; int8 products {products} over {n_audio} audio and "
          f"{n_video} video forwards; peak memory {peak:.2f} GiB ({card})")
    n_layers = svc.model.audio_encoder.wav2vec2.cfg.num_layers
    want = {"attention_fwd": n_layers * n_audio, "attention_bwd": 0,
            "triplet_loss": 1}
    want_products = {k: n_audio * INT8_PER_AUDIO[k] + n_video
                     * INT8_PER_VIDEO[k] for k in INT8_PER_AUDIO}
    if launches != want or products != want_products:
        raise AssertionError(f"int8 serving: launches {launches} != {want} "
                             f"or products {products} != {want_products}")
    for name, emb in (("audio", a), ("video", v)):
        norms = np.linalg.norm(emb, axis=1)
        if emb.shape != (40, 512) or not np.isfinite(emb).all() \
                or np.abs(norms - 1).max() > 1e-5:
            raise AssertionError(f"int8 {name} embeddings: {emb.shape}")
    if not np.isfinite(loss.item()):
        raise AssertionError(f"int8 eval loss {loss.item()}")
    t0 = time.perf_counter()
    held = _hold_int8(kept)
    print(f"int8 products card vs plain (CPU): {held} weight shapes, each "
          f"on its first input's row 0: accumulators and dequantised "
          f"outputs equal bit for bit ({time.perf_counter() - t0:.1f} s)")

    # the bf16 float path's eval step on the same batch: the cosine of the
    # embeddings (both unit-norm)
    fv, fa, _ = eval_step(model, batch)
    cos = {"audio": (fa.float() * ea.float()).sum(dim=1).min().item(),
           "video": (fv.float() * ev.float()).sum(dim=1).min().item()}
    print(f"int8 vs bf16 float embeddings (B=32, 2.3 s), min cosine: "
          f"audio {cos['audio']:.6f}, video {cos['video']:.6f} (bound "
          f"{INT8_COS})")
    if not min(cos.values()) > INT8_COS:
        raise AssertionError(f"int8 cosine to float {cos}")

    audio = torch.from_numpy(batch.audio).cuda()
    video = torch.from_numpy(batch.video).cuda()
    # encode at B=32 on 2.3 s and the audio tower at B=32 on 6.0 s, the
    # bf16 float model and the int8 one in turns (phase 3's clock and
    # statistic: median of 5 after 1)
    samples = int(round(svc.buckets[-1] * cfg.data.audio_sample_rate))
    long_audio = torch.from_numpy(rng.normal(scale=0.1, size=(32, samples))
                                  .astype(np.float32)).cuda()
    times = {(tag, what): [] for tag in ("bf16", "int8")
             for what in ("encode", "audio_6s")}
    with torch.inference_mode():
        for _ in range(6):
            for tag, m in (("bf16", model), ("int8", svc.model)):
                for what, fn in (("encode", lambda: (m.encode_audio(audio),
                                                     m.encode_video(video))),
                                 ("audio_6s",
                                  lambda: m.encode_audio(long_audio))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[tag, what].append(time.perf_counter() - t0)
    med = {k: float(np.median(t[1:])) for k, t in times.items()}
    rec = {"encode_pairs_per_s": 32 / med["int8", "encode"],
           "bf16_encode_pairs_per_s": 32 / med["bf16", "encode"],
           "audio_tower_ms_6s": med["int8", "audio_6s"] * 1e3,
           "bf16_audio_tower_ms_6s": med["bf16", "audio_6s"] * 1e3,
           "peak_memory_gib": peak, "cos_min": cos, "held_shapes": held,
           "products_per_forward": {"audio": INT8_PER_AUDIO,
                                    "video": INT8_PER_VIDEO}}
    phase3 = report.get("encode_pairs_per_s")
    print(f"int8 encode: {rec['encode_pairs_per_s']:.1f} pairs/s at B=32, "
          f"2.3 s (bf16 in turns {rec['bf16_encode_pairs_per_s']:.1f}"
          + (f"; phase 3 {phase3:.1f}" if phase3 else "") + f"); audio "
          f"tower B=32 6.0 s {rec['audio_tower_ms_6s']:.2f} ms (bf16 "
          f"{rec['bf16_audio_tower_ms_6s']:.2f} ms) ({card})")
    rec["profile"] = _int8_profile(svc.model, audio, video)
    del svc, model
    rec["f32_card_vs_cpu"] = _int8_f32_card_vs_cpu()
    report["launches"]["serve_int8"] = launches
    report["serve_int8"] = rec


# ----------------------------------------------------------------- phase 3x
EXPORT_INT8_BUCKET = 2.3  # the W8A8 programs' one bucket (3q's timed one)
ATTN_OP = "peppa_tpu_torch.mha_attention.default"
INT_MM_OP = "aten._int_mm.default"
EXAMPLE_SECONDS = (1.0, 2.0, 3.1)  # the example's 44.1 kHz WAV files


def _spawn(cmd, jobs: list):
    """Start one command from the checkout's root, its output captured;
    it joins `jobs`, which the caller kills in the end if need be."""
    job = (subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True),
           time.perf_counter())
    jobs.append(job)
    return job


def _wait(job, what: str, timeout: int = 600) -> str:
    """A started command's standard output, or raise with the end of its
    errors."""
    proc, t0 = job
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    print(f"{what}: {time.perf_counter() - t0:.1f} s")
    return out


def serve_artifacts(args) -> int:
    """Phase 3x's loading process (`chip_smoke.py --serve_artifacts
    ARTIFACT REQUESTS OUT ...`), with JAX blocked: each artifact loaded
    by `ExportedEncoders` on the card (seconds, and the peak memory of
    loading and serving it) and served its requests (a .npz of `audio_NNN`
    and `video_NNN`), the embeddings written to OUT; the program calls,
    kernel 1's launches and the plain version's calls on the card while
    serving; kernel 1 held against its plain version on the path's first
    input, and the host time to issue it through the custom op and
    straight to its launch; the modules imported so far.  Then the model code, for encode
    pairs/s at B=32 on 2.3 s: the first artifact's programs and phase 3's
    live model in turns, on phase 3's batch.  Prints one JSON line."""
    import numpy as np
    import torch

    for blocked in ("jax", "flax", "msgpack"):
        sys.modules[blocked] = None  # any import of these now fails
    sys.path.insert(0, HERE)
    from peppa_tpu_torch.export import ExportedEncoders
    from peppa_tpu_torch.ops.cuda import attention

    plain, kept = {"plain": 0}, []

    def keep_first(real):
        def run(*a, **kw):
            if not kept:
                kept.append(a)
            return real(*a, **kw)
        return run

    undos = [_patch(attention, "mha_attention_plain", _count_on_card(plain)),
             _patch(attention, "_launch", keep_first)]
    report, encoders = {"artifacts": []}, []
    for artifact, requests, emb_path in zip(args[0::3], args[1::3],
                                            args[2::3]):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        enc = ExportedEncoders(artifact)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        encoders.append(enc)
        calls = {"audio": 0, "video": 0}

        def counted(real):
            def run(kind, batch):
                calls[kind] += 1
                return real(kind, batch)
            return run

        enc.encode = counted(enc.encode)
        with np.load(requests) as z:
            items = {kind: [z[k] for k in sorted(z.files)
                            if k.startswith(kind)]
                     for kind in ("audio", "video")}
        attention.mha_attention.launches = 0
        a = enc.embed_audio(items["audio"])
        v = enc.embed_video(items["video"])
        torch.cuda.synchronize()
        report["artifacts"].append({
            "artifact": os.path.basename(artifact), "load_s": load_s,
            "peak_memory_gib": (torch.cuda.max_memory_allocated() - base)
            / 2**30, "calls": dict(calls),
            "attention_fwd": attention.mha_attention.launches})
        np.savez(emb_path, audio=a, video=v)
    for undo in undos:
        undo()
    q, k, v, lengths, scale = kept[0][:5]
    got = attention._launch(q, k, v, lengths, scale)[0]
    want = attention.mha_attention_plain(q, k, v, lengths, scale)
    report["held"] = {"shape": list(q.shape), "dtype": str(q.dtype),
                      "lengths": lengths is not None,
                      "max_abs_err": (got.float() - want.float())
                      .abs().max().item()}
    # host time to issue one call through the custom op and one straight
    # to the launch (100 each, no synchronise: the queue does not fill)
    issue = {}
    for tag, fn in (("op", lambda: attention.attention_op(q, k, v, lengths,
                                                           scale)),
                    ("launch", lambda: attention._launch(q, k, v, lengths,
                                                         scale))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        issue[tag] = (time.perf_counter() - t0) * 1e4  # us per call
        torch.cuda.synchronize()
    report["issue_us"] = issue
    report["plain_on_card"] = plain["plain"]
    report["imported"] = sorted(
        m for m, mod in sys.modules.items() if mod is not None
        and m.startswith(("peppa_tpu_torch.models", "peppa_tpu_torch.training",
                          "peppa_tpu.", "jax", "flax")))

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model

    cfg = default_config()
    rng = np.random.default_rng(0)
    _requests(rng, cfg, 40)
    batch = _clip_batch(rng, cfg, 32, 2.3)  # phase 3's timing batch
    model = init_model(cfg, seed=0)
    audio = torch.from_numpy(batch.audio).cuda()
    video = torch.from_numpy(batch.video).cuda()
    enc = encoders[0]
    fns = {"artifact": lambda: (enc.encode("audio", audio),
                                enc.encode("video", video)),
           "live": lambda: (model.encode_audio(audio),
                            model.encode_video(video))}
    times = {tag: [] for tag in fns}
    with torch.inference_mode():
        for _ in range(6):  # phase 3's clock and statistic, in turns
            for tag, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[tag].append(time.perf_counter() - t0)
    report["encode_pairs_per_s"] = {
        tag: 32 / float(np.median(t[1:])) for tag, t in times.items()}
    print(json.dumps(report))
    return 0


def _programs(path: str, tower: str) -> list:
    """Each program of an artifact: export seconds, bytes and the op
    nodes that phase 3x checks."""
    from peppa_tpu_torch.export import op_counts

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for prog in manifest["programs"]:
        f = os.path.join(path, prog["file"])
        counts = op_counts(f)
        out.append({"tower": tower, "kind": prog["kind"],
                    "file": prog["file"], "export_s": prog["export_s"],
                    "bytes": os.path.getsize(f),
                    "attention_op": counts.get(ATTN_OP, 0),
                    "int_mm": counts.get(INT_MM_OP, 0),
                    "einsum": sum(n for name, n in counts.items()
                                  if "einsum" in name)})
    return out


def _write_wavs(wav_dir: str) -> str:
    """EXAMPLE_SECONDS of seeded noise as 16-bit 44.1 kHz WAV files; their
    glob."""
    import wave

    import numpy as np

    os.makedirs(wav_dir)
    rng = np.random.default_rng(5)
    for i, seconds in enumerate(EXAMPLE_SECONDS):
        pcm = (np.clip(rng.normal(scale=0.1, size=int(44100 * seconds)),
                       -1, 1) * 32767).astype("<i2")
        with wave.open(os.path.join(wav_dir, f"{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(44100)
            w.writeframes(pcm.tobytes())
    return os.path.join(wav_dir, "*.wav")


def run_export(report: dict, card: str, root: str) -> None:
    """The deployment path (module doc, phase 3x) on phase 3's
    configuration and weights, from 3q's run directory: the export CLI
    (every bucket, B=32, both towers) and, beside it, the example CLI and
    the W8A8 towers' export at 2.3 s; the programs' op nodes, bytes and
    export seconds; a second process that loads the artifacts with JAX
    blocked and serves phase 3's requests (the W8A8 artifact those of the
    2.3 s bucket), bit for bit against the live `EncoderService`s, with
    kernel 1's launches per audio call and no plain version on the card;
    kernel 1 against its plain version on the path's first input; the
    artifacts' load seconds and peak memory; encode pairs/s, artifact and
    live in turns."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.export import export_encoders
    from peppa_tpu_torch.models.dual_encoder import PeppaPig, init_model
    from peppa_tpu_torch.serving import EncoderService
    from peppa_tpu_torch.utils.request_batching import group_by_bucket

    t_phase = time.perf_counter()
    cfg = default_config()  # bf16, full width and depth
    model = init_model(cfg, seed=0)  # phase 3's weights
    vdir = _msgpack_run(model, cfg, root)  # 3q's run directory
    work = os.path.join(root, "export")
    art, art_q = (os.path.join(work, name)
                  for name in ("artifact", "artifact_int8"))
    n_layers = model.audio_encoder.wav2vec2.cfg.num_layers
    jobs = []
    try:
        # the two CLIs in their own processes, the int8 export here, at
        # once (CPU-bound tracing and loading on the host's cores)
        export_job = _spawn([sys.executable, "-m", "peppa_tpu_torch.export",
                             vdir, art, "--platforms", "cuda"], jobs)
        example_job = _spawn([sys.executable, "-m", "peppa_tpu_torch.example",
                              "--version_dir", vdir, "--audio_glob",
                              _write_wavs(os.path.join(work, "wavs"))], jobs)
        cfg_q = default_config()
        cfg_q.tpu.quantize_int8 = True
        model_q = PeppaPig(cfg_q)
        model_q.load_state_dict(model.state_dict())
        model_q.eval().cuda()
        t0 = time.perf_counter()
        export_encoders(model_q, cfg_q, art_q, batch_size=32,
                        buckets=[EXPORT_INT8_BUCKET])
        print(f"int8 export (2 programs): {time.perf_counter() - t0:.1f} s")
        _wait(export_job, "export CLI (4 buckets x 2 towers)")
        out = _wait(example_job, "example CLI (beside them), ended within")
        line = ("Audio embedding tensor with shape: "
                f"({len(EXAMPLE_SECONDS)}, 512)")
        if out.strip().splitlines()[-1] != line:
            raise AssertionError(f"example printed {out[-500:]!r}")
        example_s = time.perf_counter() - example_job[1]  # an upper bound

        programs = _programs(art, "bf16") + _programs(art_q, "int8")
        variables_bytes = os.path.getsize(os.path.join(art, "variables.pt"))
        for p in programs:
            print(f"  {p['tower']} {p['file']}: export {p['export_s']:.2f} "
                  f"s, {p['bytes']} bytes, {p['attention_op']} attention "
                  f"op, {p['int_mm']} _int_mm, {p['einsum']} einsum nodes")
        # each artifact's programs against its own weights (the graphs
        # keep their source lines' paths, so their bytes grow with the
        # checkout's path)
        share = {tower: sum(p["bytes"] for p in programs
                            if p["tower"] == tower) / os.path.getsize(
                                os.path.join(path, "variables.pt"))
                 for tower, path in (("bf16", art), ("int8", art_q))}
        print(f"variables.pt {variables_bytes} bytes; the programs' bytes "
              f"a share of it: " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in share.items()))
        for p in programs:
            want = {"attention_op": n_layers if p["kind"] == "audio" else 0,
                    "einsum": 0,
                    "int_mm": 0 if p["tower"] == "bf16" else sum(
                        (INT8_PER_AUDIO if p["kind"] == "audio"
                         else INT8_PER_VIDEO).values())}
            if {k: p[k] for k in want} != want:
                raise AssertionError(f"program graph {p} != {want}")
        if (len(programs) != 2 * len(cfg.tpu.bucket_durations) + 2
                or max(share.values()) >= 0.05):
            raise AssertionError(f"programs {programs}, weights "
                                 f"{variables_bytes} bytes")

        # phase 3's requests (its generator's first draws), served live
        rng = np.random.default_rng(0)
        waves, clips = _requests(rng, cfg, 40)
        svc = EncoderService(model, cfg, batch_size=32)
        svc_q = EncoderService(model_q, cfg_q, batch_size=32)
        s23 = int(round(EXPORT_INT8_BUCKET * cfg.data.audio_sample_rate))
        t23 = int(round(EXPORT_INT8_BUCKET * svc.fps))
        sub = {"audio": [w for w in waves
                         if svc._audio_bucket(len(w)) == s23],
               "video": [c for c in clips
                         if svc._video_bucket(len(c)) == t23]}
        live = {"bf16": (svc.embed_audio(waves), svc.embed_video(clips)),
                "int8": (svc_q.embed_audio(sub["audio"]),
                         svc_q.embed_video(sub["video"]))}
        groups = group_by_bucket(clips, lambda x: svc._video_bucket(len(x)))
        want_calls = {"bf16": {"audio": _audio_batches(svc, waves),
                               "video": sum(-(-len(i) // 32)
                                            for i in groups.values())},
                      "int8": {"audio": 1, "video": 1}}
        del svc, svc_q, model, model_q
        torch.cuda.empty_cache()
        args = []
        for tag, path, reqs in (("bf16", art, {"audio": waves,
                                               "video": clips}),
                                ("int8", art_q, sub)):
            req = os.path.join(work, f"requests_{tag}.npz")
            np.savez(req, **{f"{kind}_{i:03d}": x
                             for kind, xs in reqs.items()
                             for i, x in enumerate(xs)})
            args += [path, req, os.path.join(work, f"emb_{tag}.npz")]
        out = _wait(_spawn([sys.executable,
                            os.path.join(HERE, "chip_smoke.py"),
                            "--serve_artifacts", *args], jobs),
                    "artifact serving (JAX blocked)")
    finally:
        for proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    served = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(served))
    differ = []
    for (tag, (a_live, v_live)), rec in zip(live.items(),
                                            served["artifacts"]):
        with np.load(os.path.join(work, f"emb_{tag}.npz")) as z:
            a, v = z["audio"], z["video"]
        rec["bit_for_bit"] = bool(np.array_equal(a, a_live)
                                  and np.array_equal(v, v_live))
        rec["max_abs_vs_live"] = max(float(np.abs(a - a_live).max()),
                                     float(np.abs(v - v_live).max()))
        print(f"{tag} artifact vs live EncoderService: bit for bit "
              f"{rec['bit_for_bit']} (max|d| {rec['max_abs_vs_live']:.3g}); "
              f"calls {rec['calls']}, kernel 1 launches "
              f"{rec['attention_fwd']}, load {rec['load_s']:.2f} s, peak "
              f"memory {rec['peak_memory_gib']:.2f} GiB")
        if not rec["bit_for_bit"]:
            differ.append(tag)
        if (rec["calls"] != want_calls[tag] or rec["attention_fwd"]
                != n_layers * rec["calls"]["audio"]):
            raise AssertionError(f"{tag} artifact: {rec}, calls "
                                 f"{want_calls[tag]}")
    held = served["held"]
    print(f"kernel 1 on the artifact path's first input {held}: max|d| "
          f"{held['max_abs_err']:.3g} (tol {TOL_ATTN['bfloat16']}); host "
          f"issue per call through the custom op "
          f"{served['issue_us']['op']:.1f} us, straight to the launch "
          f"{served['issue_us']['launch']:.1f} us")
    if (served["plain_on_card"] or served["imported"] or differ
            or not held["max_abs_err"] <= TOL_ATTN["bfloat16"]):
        raise AssertionError(f"artifact serving: plain on card "
                             f"{served['plain_on_card']}, imported "
                             f"{served['imported']}, differ {differ}, held "
                             f"{held}")
    rate = served["encode_pairs_per_s"]
    phase3 = report.get("encode_pairs_per_s")
    print(f"encode at B=32, 2.3 s, in turns: artifact {rate['artifact']:.1f}"
          f" pairs/s, live {rate['live']:.1f}"
          + (f" (phase 3 {phase3:.1f})" if phase3 else "") + f" ({card})")
    shutil.rmtree(work)
    report["launches"]["export"] = {
        "attention_fwd": sum(r["attention_fwd"] for r in served["artifacts"]),
        "attention_bwd": 0, "triplet_loss": 0}
    report["export"] = {
        "programs": programs, "variables_bytes": variables_bytes,
        "program_share": share,
        "serving": served, "example_s": example_s,
        "phase_s": time.perf_counter() - t_phase}


# ------------------------------------------------------------------ phase 4
TRAIN_TAGS = {"deterministic": "train_deterministic",  # 4a
              "default": "train_default",  # 4b
              "f32": "train_f32"}  # 4e


def run_training(report: dict, card: str, mode: str) -> None:
    """2 optimizer steps (16 micro-steps) of the base configuration at full
    width and depth, micro-batch 8 of 2.3 s clips: bf16 with `audio.dropout:
    0.0` ("deterministic", 4a) or the defaults ("default", 4b), or float32
    with `audio.dropout: 0.0` ("f32", 4e: kernels 1 and 2 in float32, held
    against their plain versions on the path's first inputs)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.cuda import attention
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    tag = TRAIN_TAGS[mode]
    deterministic = mode != "default"
    cfg = default_config()
    if deterministic:
        cfg.audio.dropout = 0.0  # every stochastic rate: attention kernels
    if mode == "f32":
        cfg.training.precision = "fp32"
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
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
    kept = {}  # the float32 forward's and backward's first inputs here
    undos = ([_patch(attention, name, _keep_first(kept, name))
              for name in ("_launch", "_launch_bwd")] if mode == "f32"
             else [])
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
    for undo in undos:
        undo()
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
    print(f"{tag}: {cfg.training.precision}, TF32 in force: matmul "
          f"{tf32['matmul']}, cudnn {tf32['cudnn']}")
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
                   "peak_memory_gib": peak, "precision":
                   cfg.training.precision, "allow_tf32": tf32,
                   "losses": losses}
    if mode == "f32":
        report[tag]["attention_held"] = _hold_fwd_f32(kept["_launch"], tag)
        report[tag]["attention_bwd_held"] = _hold_bwd_f32(
            kept["_launch_bwd"], tag)
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


def _keep_first(kept: dict, name: str):
    """A `_patch` wrapper that keeps the arguments of the first call in
    kept[name], tensors cloned."""
    import torch

    def wrap(real):
        def run(*args, **kw):
            if name not in kept:
                kept[name] = [a.detach().clone()
                              if isinstance(a, torch.Tensor) else a
                              for a in args]
            return real(*args, **kw)
        return run
    return wrap


def _fwd_f32_error(q, k, v, lengths, scale, out, lse, what: str) -> float:
    """max |kernel - plain| of kernel 1's float32 output `out` and
    natural-log log-sum-exp `lse` for q, k, v; raises where the output is
    off by more than TOL_ATTN or the lse by more than it + it|lse|."""
    import torch

    from peppa_tpu_torch.ops.cuda.attention import mha_attention_plain

    tol = TOL_ATTN["float32"]
    t = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if lengths is not None:
        mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    want = torch.logsumexp(logits, -1)
    err = (out - mha_attention_plain(q, k, v, lengths, scale)).abs().max()
    lse_d = (lse - want).abs()
    print(f"{what}: attention float32 at {list(q.shape)} (lengths "
          f"{'none' if lengths is None else 'given'}): output max|d|="
          f"{err.item():.3g} (tol {tol}), lse max|d|={lse_d.max().item():.3g} "
          f"(tol {tol} + {tol}|lse|)")
    if not err.item() <= tol or not bool((lse_d <= tol + tol * want.abs())
                                         .all()):
        raise AssertionError(f"{what}: attention float32 output "
                             f"{err.item()}, lse {lse_d.max().item()}")
    return err.item()


def _hold_fwd_f32(args: list, tag: str) -> dict:
    """Kernel 1's float32 route run again on the first inputs a path gave
    it (`_launch`'s arguments: q, k, v, lengths, scale), with the path's
    key splits (`_f32_plan`), held against its plain version."""
    import torch

    from peppa_tpu_torch.ops.cuda.attention import _f32_plan, _launch

    q, k, v, lengths, scale = args[:5]
    if q.dtype != torch.float32:
        raise AssertionError(f"{tag}: the forward ran in {q.dtype}")
    b, t, h, _ = q.shape
    splits = _f32_plan(b, h, t)[1]
    out, lse = _launch(q, k, v, lengths, scale, with_lse=True)
    err = _fwd_f32_error(q, k, v, lengths, scale, out, lse,
                         f"{tag} ({splits} key splits)")
    return {"shape": list(q.shape), "key_splits": splits,
            "max_abs_err": err}


def _bwd_f64(q, k, v, do, lengths, scale) -> tuple:
    """(dq, dk, dv) of the attention in float64 by autograd: the reference
    that shows how far float32 itself, kernel or plain, is from them."""
    import torch

    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if lengths is not None:
        t = q.shape[1]
        mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    return torch.autograd.grad(out, (q, k, v), do.double())


def _hold_bwd_f32(args: list, tag: str) -> dict:
    """Kernel 2's float32 route against its plain version on the inputs a
    path gave it (`_launch_bwd`'s arguments: q, k, v, dO, the forward's
    lse and output, lengths, scale).  The path's dO (dL/dO of a mean loss)
    makes gradients far below 1, so they are held within 1e-4 of the
    largest |plain| of the three + 1e-4|plain|, and each one's error is
    given beside that of the plain version, both against float64; then the
    same q, k, v, lse and output with a unit-scale dO, at phase 2's 1e-4 +
    1e-4|plain|.  The output and lse the path saved are held first."""
    import torch

    from peppa_tpu_torch.ops.cuda.attention import (mha_attention_bwd,
                                                    mha_attention_bwd_plain)

    q, k, v, do, lse, out, lengths, scale = args
    if q.dtype != torch.float32:
        raise AssertionError(f"{tag}: the backward ran in {q.dtype}")
    fwd_err = _fwd_f32_error(q, k, v, lengths, scale, out, lse,
                             f"{tag} (the backward's saved output)")
    got = mha_attention_bwd(q, k, v, do, lengths, scale, lse, out)
    want = mha_attention_bwd_plain(q, k, v, do, lengths, scale)
    largest = max(w.abs().max().item() for w in want)
    tol = TOL_ATTN_BWD["float32"]
    err = _bwd_error(got, want, f"{tag} path's dO", atol=tol * largest)
    exact = _bwd_f64(q, k, v, do, lengths, scale)
    against_f64 = {}
    for gname, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        against_f64[gname] = {"max_abs": x.abs().max().item(),
                              "kernel": (g.double() - x).abs().max().item(),
                              "plain": (w.double() - x).abs().max().item()}
        print(f"{tag}: {gname} against float64: max|f64| "
              f"{against_f64[gname]['max_abs']:.3g}, kernel max|d| "
              f"{against_f64[gname]['kernel']:.3g}, plain max|d| "
              f"{against_f64[gname]['plain']:.3g}")
    del exact
    gen = torch.Generator(device="cuda").manual_seed(4)
    unit = torch.randn(do.shape, generator=gen, device="cuda")
    unit_err = _bwd_error(
        mha_attention_bwd(q, k, v, unit, lengths, scale, lse, out),
        mha_attention_bwd_plain(q, k, v, unit, lengths, scale),
        f"{tag} unit-scale dO")
    print(f"{tag}: attention bwd float32 at the path's {list(q.shape)}: "
          f"max|d|={err:.3g} with its dO (max|plain|={largest:.3g}, "
          f"max|d|/max|plain|={err / max(largest, 1e-30):.3g}), "
          f"{unit_err:.3g} with a unit-scale dO")
    return {"shape": list(q.shape), "max_abs_err": err,
            "max_abs_plain": largest, "against_f64": against_f64,
            "max_abs_err_unit_do": unit_err,
            "saved_output_max_abs_err": fwd_err}


# ----------------------------------------------------------------- phase 4p
DP_RANKS, DP_B, DP_K, DP_MICRO_STEPS = 2, 4, 2, 4  # per rank; k; steps
DP_TIMEOUT = 600  # seconds for the two ranks' processes
DP_LAYERS = 12  # wav2vec2-base's: kernels 1 and 2 once per layer a step


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_config(precision: str):
    """4a's configuration (`audio.dropout: 0.0`: kernels 1 and 2 both ways)
    in `precision`, with k = DP_K: the second micro-step takes an optimizer
    step (lr 0 under warmup_linear), the fourth one that moves."""
    from peppa_tpu_torch.config import default_config

    cfg = default_config()
    cfg.audio.dropout = 0.0
    cfg.training.precision = precision
    cfg.training.accumulate_grad_batches = DP_K
    return cfg


def _dp_world_one(report: dict, card: str) -> None:
    """Phase 4p (a): 4a's configuration and batches (k = DP_K) for
    DP_MICRO_STEPS micro-steps in one process, then through the
    distributed code path over NCCL at world size 1 in this process
    (`init_distributed`, `make_mesh`, the gradient all-reduce): the same
    losses and the same state bit for bit, and the losses 4a's.  Both
    runs take cuDNN's deterministic algorithms: its default weight
    gradients add with atomics, so two runs of one process differ in the
    last bits of conv0's gradient."""
    import numpy as np
    import torch
    import torch.distributed as td

    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.parallel.mesh import make_mesh
    from peppa_tpu_torch.training.checkpoint import snapshot
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step
    from peppa_tpu_torch.utils.dist import init_distributed

    cfg = _dp_config("bf16")
    rng = np.random.default_rng(2)  # 4a's batches, in 4a's order
    batches = [_clip_batch(rng, cfg, TRAIN_B, TRAIN_SECONDS)
               for _ in range(DP_MICRO_STEPS)]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("one process", "NCCL"):
            mesh = None
            if name == "NCCL":
                os.environ.update(env)
                init_distributed()
                mesh = make_mesh()
                if td.get_backend() != "nccl" or mesh.group is None:
                    raise AssertionError(f"4p: backend {td.get_backend()}")
            model = init_model(cfg, seed=0)
            state = TrainState.create(model, cfg, mesh)
            _reset_counts()
            t0 = time.perf_counter()
            losses = [train_step(state, b, seed=0)[1]["train_loss"]
                      for b in batches]
            torch.cuda.synchronize()
            runs[name] = {"losses": [x.item() for x in losses],
                          "launches": _counts(),
                          "s": time.perf_counter() - t0}
            if name == "one process":
                kept = snapshot(state)
            else:
                runs[name]["tensors_equal"] = _same_state(
                    kept, state.state_dict())
            del state, model
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if td.is_initialized():
            td.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    one, nccl = runs["one process"], runs["NCCL"]
    want = {"attention_fwd": DP_LAYERS * DP_MICRO_STEPS,
            "attention_bwd": DP_LAYERS * DP_MICRO_STEPS,
            "triplet_loss": DP_MICRO_STEPS}
    print(f"4p (a): {DP_MICRO_STEPS} micro-steps of 4a's configuration "
          f"(k={DP_K}) in one process and over NCCL at world size 1: "
          f"losses {nccl['losses']}; launches {nccl['launches']}; "
          f"{nccl['tensors_equal']} state tensors (parameters, statistics, "
          f"moments, buffers) equal bit for bit; {one['s']:.1f} / "
          f"{nccl['s']:.1f} s")
    if nccl["losses"] != one["losses"] or nccl["launches"] != want \
            or one["launches"] != want:
        raise AssertionError(f"4p (a): {runs}")
    ref = report.get("train_deterministic")
    if ref is not None:
        if nccl["losses"] != ref["losses"][:DP_MICRO_STEPS]:
            raise AssertionError(f"4p (a): losses {nccl['losses']} are not "
                                 f"4a's {ref['losses'][:DP_MICRO_STEPS]}")
        print("4p (a): the losses equal 4a's first "
              f"{DP_MICRO_STEPS} bit for bit")
    report["launches"]["train_dp_w1"] = nccl["launches"]
    report["train_dp"].update(w1_losses=nccl["losses"],
                              w1_tensors_equal=nccl["tensors_equal"],
                              w1_equals_4a=ref is not None)


def _dp_hold(got: dict, want: dict, start=None) -> dict:
    """The worst share of its tolerance each tower uses (<= 1 passes), as
    phase 5 holds gradients: the audio tensors' max|d| against 1e-3 of the
    tensor's largest entry, the video tensors' |d| against 10% of the
    norm.  With `start`, parameters: the audio tolerance plus 1e-3 lr (the
    attention pools' biases start at 0 with gradients near rounding level,
    where BertAdam's update is proportional to the gradient), and the video
    tower's updates as one vector (BertAdam's first updates are about
    lr * 3.2 * sign(g): one sign flipped by rounding in a tensor of a few
    dozen BatchNorm scales is a third of its update's norm)."""
    lr = 1e-4  # hparams_base.yaml's
    worst = {"audio": (0.0, ""), "video": (0.0, "")}
    video_d2 = video_u2 = 0.0
    for name, w in want.items():
        d = got[name].float() - w.float()
        if name.startswith("video_encoder."):
            if start is not None:
                video_d2 += float(d.square().sum())
                video_u2 += float((w.float() - start[name].float())
                                  .square().sum())
                continue
            used = (d.norm() / (0.1 * w.float().norm() + 1e-8)).item()
            worst["video"] = max(worst["video"], (used, name))
        else:
            floor = 1e-3 * lr if start is not None else 1e-8
            used = (d.abs().max() / (1e-3 * w.abs().max() + floor)).item()
            worst["audio"] = max(worst["audio"], (used, name))
    if start is not None:
        worst["video"] = (video_d2 ** 0.5 / (0.1 * video_u2 ** 0.5 + 1e-8),
                          "the tower")
    return worst


def dp_rank(argv) -> int:
    """A rank of phase 4p (b), in a process of its own: `chip_smoke.py
    --dp_rank RANK PORT DIR`.  Both ranks share card 0 over gloo on CUDA
    tensors (NCCL refuses two ranks on one device).  Each trains
    DP_MICRO_STEPS float32 micro-steps of DP_B 2.3 s clips, its slab of
    global batches of DP_RANKS * DP_B; rank 0 then holds kernels 1 and 2
    against their plain versions on the first inputs its two-rank run gave
    them (float32 at B = DP_B: 3 key splits, a plan no other phase runs at
    T = 316), takes the same steps in one process on the global batches
    and holds the two runs against each other.  Writes
    DIR/rank_RANK.json."""
    rank, port, out_dir = argv
    sys.path.insert(0, HERE)
    os.environ.update(RANK=rank, WORLD_SIZE=str(DP_RANKS), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as td

    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.cuda import attention, loss
    from peppa_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step
    from peppa_tpu_torch.utils.dist import init_distributed

    init_distributed("cuda:0", backend="gloo")
    mesh = make_mesh()
    cfg = _dp_config("fp32")
    rng = np.random.default_rng(5)
    global_batches = [_clip_batch(rng, cfg, DP_RANKS * DP_B, TRAIN_SECONDS)
                      for _ in range(DP_MICRO_STEPS)]
    record = {"plain": 0}
    modules = {"attention": attention, "loss": loss}
    undo = [_patch(modules[m], name, _count_on_card(record))
            for m, name in PLAIN_VERSIONS]

    def train(batches, mesh):
        """The micro-steps from the seeded init: losses, host-clock and
        CUDA-event ms, the gradient handed to BertAdam and the parameters
        after each optimizer step, the running statistics at the end."""
        model = init_model(cfg, seed=0)
        state = TrainState.create(model, cfg, mesh)
        taken = []
        real_step = state.optimizer.step

        def step():  # the reduced mean, then the update
            grads = {n: p.grad.detach().clone()
                     for n, p in state.params.items()}
            real_step()
            taken.append((grads, {n: p.detach().clone()
                                  for n, p in state.params.items()}))

        state.optimizer.step = step
        out = {"start": {n: p.detach().clone()
                         for n, p in state.params.items()}}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        losses, events = [], []
        for i, batch in enumerate(batches):
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
            state, m = train_step(state, batch, seed=0)
            events[-1][1].record()
            losses.append(m["train_loss"])
            if i == 0:  # micro-step 1 warms up; time the others
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        torch.cuda.synchronize()
        out.update(
            ms=(time.perf_counter() - t1) / (len(batches) - 1) * 1e3,
            event_ms=[a.elapsed_time(b) for a, b in events[1:]],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=_counts(), losses=[x.item() for x in losses],
            taken=taken, stats={n: b.clone() for n, b in
                                model.named_buffers() if "running_" in n})
        h = hashlib.sha256()
        for t in model.state_dict().values():
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        out["digest"] = h.hexdigest()
        return out

    kept = {}  # rank 0's first float32 forward and backward inputs
    try:
        keep = ([_patch(attention, name, _keep_first(kept, name))
                 for name in ("_launch", "_launch_bwd")]
                if mesh.rank == 0 else [])
        try:
            two = train([shard_batch(b, mesh) for b in global_batches], mesh)
        finally:
            for u in keep:
                u()
        result = {k: two[k] for k in ("ms", "event_ms", "peak_gib",
                                      "launches", "losses", "digest")}
        result["plain"] = record["plain"]
        if mesh.rank == 0:
            tag = "4p (b) rank 0"
            result["attention_held"] = _hold_fwd_f32(kept["_launch"], tag)
            result["attention_bwd_held"] = _hold_bwd_f32(
                kept["_launch_bwd"], tag)
            one = train(global_batches, None)
            result["one_losses"] = one["losses"]
            result["one_ms"] = one["ms"]
            result["one_launches"] = one["launches"]
            held = {}
            for i, ((g2, p2), (g1, p1)) in enumerate(zip(two["taken"],
                                                         one["taken"])):
                held[f"grads_{i + 1}"] = _dp_hold(g2, g1)
                held[f"params_{i + 1}"] = _dp_hold(p2, p1, one["start"])
            stats = max(((two["stats"][n] - w).abs().max()
                         / (1e-3 * w.abs().max() + 1e-6)).item()
                        for n, w in one["stats"].items())
            held["running_stats"] = stats
            result["held"] = held
            # the first optimizer step's learning rate is 0
            first2, first1 = two["taken"][0][1], one["taken"][0][1]
            result["steps_equal_before_the_update"] = all(
                torch.equal(first2[n], first1[n]) for n in first1)
    finally:
        for u in undo:
            u()
        td.destroy_process_group()
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def _dp_two_ranks(report: dict, card: str) -> None:
    """Phase 4p (b): two rank processes (`dp_rank`) sharing the card;
    their results held and summed."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp_rank", str(r),
         port, out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"4p rank {r} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    summed = {k: sum(r["launches"][k] for r in ranks)
              for k in r0["launches"]}
    per_rank = {"attention_fwd": DP_LAYERS * DP_MICRO_STEPS,
                "attention_bwd": DP_LAYERS * DP_MICRO_STEPS,
                "triplet_loss": 0}
    for r, res in enumerate(ranks):
        print(f"4p (b) rank {r}: launches {res['launches']}, plain calls on "
              f"the card {res['plain']}; {res['ms']:.2f} ms per micro-step "
              f"(host clock, micro-steps 2-{DP_MICRO_STEPS}; CUDA events "
              f"{[round(x, 2) for x in res['event_ms']]}), peak "
              f"{res['peak_gib']:.2f} GiB: two ranks sharing one card "
              f"measure correctness and overhead, not scaling ({card})")
    fwd, bwd = r0["attention_held"], r0["attention_bwd_held"]
    print(f"4p (b) rank 0: kernel 1 float32 at {fwd['shape']} ("
          f"{fwd['key_splits']} key splits) max|d| {fwd['max_abs_err']:.3g} "
          f"against plain; kernel 2 float32 max|d| {bwd['max_abs_err']:.3g} "
          f"with the path's dO (max|plain| {bwd['max_abs_plain']:.3g}), "
          f"{bwd['max_abs_err_unit_do']:.3g} with a unit-scale dO")
    held = r0["held"]
    print(f"4p (b): {DP_RANKS} ranks x B={DP_B} of {TRAIN_SECONDS} s, "
          f"float32, k={DP_K}, {DP_MICRO_STEPS} micro-steps (gloo on CUDA "
          f"tensors) in {wall:.1f} s with the processes' start; losses "
          f"{r0['losses']} against one process on the {DP_RANKS * DP_B}-row "
          f"batches {r0['one_losses']} ({r0['one_ms']:.2f} ms per "
          f"micro-step there); worst share of the tolerance used {held}; "
          f"ranks' states alike: {ranks[0]['digest'] == ranks[1]['digest']}")
    failed = []
    if any(r["launches"] != per_rank or r["plain"] for r in ranks):
        failed.append(f"launches {[r['launches'] for r in ranks]}, plain "
                      f"{[r['plain'] for r in ranks]}")
    if ranks[0]["losses"] != ranks[1]["losses"] \
            or ranks[0]["digest"] != ranks[1]["digest"]:
        failed.append("the ranks disagree")
    if not all(abs(a - b) <= 1e-4 * abs(b)
               for a, b in zip(r0["losses"], r0["one_losses"])):
        failed.append("losses")
    for key, worst in held.items():
        shares = [worst] if key == "running_stats" else \
            [v[0] for v in worst.values()]
        if not all(s <= 1.0 for s in shares):
            failed.append(f"{key} {worst}")
    if not r0["steps_equal_before_the_update"]:
        failed.append("the lr-0 optimizer step moved a parameter")
    if failed:
        raise AssertionError(f"4p (b): {failed}")
    report["launches"]["train_dp_w2"] = summed
    report["train_dp"].update(
        w2_ms_per_micro_step=[r["ms"] for r in ranks],
        w2_event_ms=[r["event_ms"] for r in ranks],
        w2_peak_memory_gib=[r["peak_gib"] for r in ranks],
        w2_losses=r0["losses"], one_process_losses=r0["one_losses"],
        one_process_ms_per_micro_step=r0["one_ms"], held=held,
        w2_wall_s=wall, attention_held=r0["attention_held"],
        attention_bwd_held=r0["attention_bwd_held"])


def run_data_parallel(report: dict, card: str) -> None:
    """Phase 4p (module doc): (a) then (b)."""
    report.setdefault("train_dp", {})
    _dp_world_one(report, card)
    _dp_two_ranks(report, card)


# ----------------------------------------------------------------- phase 4r
REMAT_STATIC_STEPS, REMAT_STATIC_K = 4, 2  # the static tower's runs


def _remat_run(cfg, batches) -> dict:
    """`train_step` on `batches` from the seed-0 weights: the losses, the
    means handed to BertAdam (host copies), the final state (host copy),
    the launches, the CUDA-event ms of micro-steps 2 on and the peak
    memory."""
    import numpy as np
    import torch

    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.training.checkpoint import snapshot
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    model = init_model(cfg, seed=0)
    state = TrainState.create(model, cfg)
    handed = []
    opt_step = state.optimizer.step

    def kept_step(*a, **kw):
        handed.append({n: p.grad.detach().to("cpu")
                       for n, p in state.params.items()})
        return opt_step(*a, **kw)

    state.optimizer.step = kept_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, events = [], []
    for batch in batches:
        events.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        state, m = train_step(state, batch, seed=0)
        events[-1][1].record()
        losses.append(m["train_loss"])
    torch.cuda.synchronize()
    launches = _counts()
    step_ms = [a.elapsed_time(b) for a, b in events[1:]]
    out = {"losses": [x.item() for x in losses], "handed": handed,
           "launches": launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "event_ms_median": float(np.median(step_ms)),
           "event_ms_range": [min(step_ms), max(step_ms)],
           "state": snapshot(state)}
    del state, model
    return out


def _same_runs(tag: str, got: dict, want: dict) -> int:
    """The remat run against the plain one, bit for bit: the losses, the
    means handed to BertAdam, every state tensor after the last step
    (parameters, running statistics, moments, buffers).  Returns the
    number of tensors held; raises at the first that differs."""
    import torch

    if got["losses"] != want["losses"]:
        raise AssertionError(f"{tag}: losses {got['losses']} != "
                             f"{want['losses']}")
    if len(got["handed"]) != len(want["handed"]):
        raise AssertionError(f"{tag}: {len(got['handed'])} optimizer "
                             f"steps != {len(want['handed'])}")
    n = 0
    for i, (g, w) in enumerate(zip(got["handed"], want["handed"])):
        for name in w:
            if not torch.equal(g[name], w[name]):
                d = (g[name] - w[name]).abs().max().item()
                raise AssertionError(
                    f"{tag}: the gradient of {name} handed to BertAdam at "
                    f"optimizer step {i + 1} differs (max|d| {d:.3g})")
            n += 1
    return n + _same_state(want["state"], got["state"])


def run_remat(report: dict, card: str) -> None:
    """Phase 4r (module doc): 4a's configuration (B=8 of 2.3 s, k=8, 16
    micro-steps) with `tpu.remat_audio` and `remat_video` against the same
    run without them, with `audio.dropout: 0.0` (kernels 1 and 2) and with
    the defaults (dropout and layer-drop, where the recompute must draw the
    first run's masks), then the static tower (k=2, 4 micro-steps), all
    with cuDNN's deterministic algorithms (its default weight gradients
    add with atomics: two runs of one process would differ)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config

    rng = np.random.default_rng(2)  # 4a's batches, in 4a's order
    cfg0 = default_config()
    batches = [_clip_batch(rng, cfg0, TRAIN_B, TRAIN_SECONDS)
               for _ in range(TRAIN_MICRO_STEPS)]
    n_layers = 12  # wav2vec2-base's
    record = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("dropout0", "default", "static"):
            cfg = default_config()
            steps = TRAIN_MICRO_STEPS
            if mode == "dropout0":
                cfg.audio.dropout = 0.0
            if mode == "static":
                cfg.video.static = True
                cfg.video.version = "static"
                cfg.training.accumulate_grad_batches = REMAT_STATIC_K
                steps = REMAT_STATIC_STEPS
            runs = {}
            for remat in (False, True):
                cfg.tpu.remat_audio = cfg.tpu.remat_video = remat
                tag = f"remat_{'on' if remat else 'off'}_{mode}"
                t0 = time.perf_counter()
                runs[remat] = run = _remat_run(cfg, batches[:steps])
                per_step = {k: v / steps for k, v in run["launches"].items()}
                print(f"4r {tag}: {steps} micro-steps in "
                      f"{time.perf_counter() - t0:.1f} s with the init; "
                      f"peak memory {run['peak_memory_gib']:.2f} GiB; CUDA "
                      f"events: median {run['event_ms_median']:.2f} ms per "
                      f"micro-step ({run['event_ms_range'][0]:.2f}-"
                      f"{run['event_ms_range'][1]:.2f}; micro-steps 2-"
                      f"{steps}); launches {run['launches']} "
                      f"({per_step} per micro-step); losses "
                      f"{[round(x, 6) for x in run['losses']]} ({card})")
                report["launches"][tag] = run["launches"]
                attn = n_layers * steps if mode == "dropout0" else 0
                want = {"attention_fwd": attn * (2 if remat else 1),
                        "attention_bwd": attn, "triplet_loss": steps}
                if run["launches"] != want:
                    raise AssertionError(f"4r {tag}: launches "
                                         f"{run['launches']} != {want}")
                if not all(np.isfinite(run["losses"])):
                    raise AssertionError(f"4r {tag}: losses {run['losses']}")
            off, on = runs[False], runs[True]
            held = _same_runs(f"4r {mode}", on, off)
            saved = off["peak_memory_gib"] - on["peak_memory_gib"]
            print(f"4r {mode}: remat equals the plain run bit for bit: the "
                  f"{steps} losses and {held} tensors (the gradients handed "
                  f"to BertAdam at {len(off['handed'])} optimizer steps, "
                  f"then every parameter, running statistic, moment and "
                  f"buffer); peak memory {off['peak_memory_gib']:.2f} -> "
                  f"{on['peak_memory_gib']:.2f} GiB ({saved:.2f} GiB "
                  f"less), {off['event_ms_median']:.2f} -> "
                  f"{on['event_ms_median']:.2f} ms per micro-step")
            if mode != "static" and not saved >= 1.0:
                raise AssertionError(f"4r {mode}: remat saved {saved:.2f} "
                                     "GiB, not the 1 GiB expected")
            record[mode] = {
                "micro_steps": steps, "tensors_equal": held,
                "peak_memory_gib": [off["peak_memory_gib"],
                                    on["peak_memory_gib"]],
                "event_ms_median": [off["event_ms_median"],
                                    on["event_ms_median"]],
                "event_ms_range": [off["event_ms_range"],
                                   on["event_ms_range"]],
                "launches": [off["launches"], on["launches"]]}
            del runs, off, on
    finally:
        torch.backends.cudnn.deterministic = deterministic
    report["remat"] = record


# ----------------------------------------------------------------- phase 4s
PROFILE_STEPS = 2  # PEPPA_PROFILE_STEPS: micro-steps 2 and 3 traced
PROFILE_KERNELS = ("attention_fwd_bf16_kernel", "attention_bwd_dq_bf16_kernel",
                   "attention_bwd_dkdv_bf16_kernel", "loss_cluster_kernel")
SWEEP_B, SWEEP_TRAIN_BATCHES, SWEEP_VAL_BATCHES = 4, 3, 1
SWEEP_SAMPLES = 20  # the battery's bootstrap subsets
SWEEP_EPISODES_TRAIN, SWEEP_EPISODES_VAL = 4, 2  # two 7 s clips each


def _profile_window(report: dict, card: str, root: str) -> dict:
    """`Trainer.fit` of 4a's configuration (`audio.dropout: 0.0`: kernels
    1 and 2 in the micro-steps) on synthetic clips with PEPPA_PROFILE_DIR
    and PEPPA_PROFILE_STEPS: one trace, parsed, holding micro-steps
    PROFILE_STEPS to 2 PROFILE_STEPS - 1 as `train_step` ranges and kernels
    1 and 3 by name."""
    import glob
    import shutil

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.data.datamodule import SyntheticPigData
    from peppa_tpu_torch.training.loop import Trainer

    cfg = default_config()
    cfg.audio.dropout = 0.0
    cfg.training.max_epochs = 1
    cfg.training.limit_train_batches = 2 * PROFILE_STEPS + 1
    cfg.training.limit_val_batches = 1
    cfg.training.num_sanity_val_steps = 0
    data = SyntheticPigData(cfg, n_train=TRAIN_B * (2 * PROFILE_STEPS + 1),
                            n_val=TRAIN_B)
    work = tempfile.mkdtemp(prefix="chip_smoke_profile_", dir=root)
    trace_dir = os.path.join(work, "trace")
    saved = {k: os.environ.get(k)
             for k in ("PEPPA_PROFILE_DIR", "PEPPA_PROFILE_STEPS")}
    os.environ.update(PEPPA_PROFILE_DIR=trace_dir,
                      PEPPA_PROFILE_STEPS=str(PROFILE_STEPS))
    try:
        _reset_counts()
        t0 = time.perf_counter()
        Trainer(cfg, log_dir=os.path.join(work, "runs")).fit(data)
        fit_s = time.perf_counter() - t0
        launches = _counts()
        files = glob.glob(os.path.join(trace_dir, "*.json"))
        if len(files) != 1:
            raise AssertionError(f"4s: {len(files)} trace files: {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    # the host's ranges (the profiler adds a device-side copy of each)
    ranges = sum(e.get("name") == "train_step"
                 and e.get("cat") == "user_annotation" for e in events)
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            for name in PROFILE_KERNELS:
                if name in e.get("name", ""):
                    kernels[name] = kernels.get(name, 0) + 1
    print(f"4s profile window: fit of {2 * PROFILE_STEPS + 1} micro-steps "
          f"in {fit_s:.1f} s, PEPPA_PROFILE_STEPS={PROFILE_STEPS}: one "
          f"trace of {size} bytes, {len(events)} events, {ranges} "
          f"train_step ranges; kernel events by name {kernels}; launches "
          f"{launches} ({card})")
    report["launches"]["profile_fit"] = launches
    if ranges != PROFILE_STEPS:
        raise AssertionError(f"4s: {ranges} train_step ranges in the trace")
    want = {"attention_fwd_bf16_kernel": 12 * PROFILE_STEPS,
            "loss_cluster_kernel": PROFILE_STEPS}  # one cluster at B = 8
    for name, least in want.items():
        if kernels.get(name, 0) < least:
            raise AssertionError(f"4s: the trace holds {kernels} kernel "
                                 f"events, fewer than {least} of {name}")
    return {"fit_s": fit_s, "trace_bytes": size, "events": len(events),
            "train_step_ranges": ranges, "kernel_events": kernels}


def run_ablation_sweep(report: dict, card: str, root: str) -> None:
    """Phase 4s (module doc): the profile window, then
    `ablation_sweep.run_sweep` at full width (180x100 at 10 fps, 44.1
    kHz, wav2vec2-base and R(2+1)D-18 or the static ResNet-18, bf16) on a
    small synthetic tree: the seven conditions trained and scored, each
    fit's seconds and launches, the scoring's, 7 distinct versions and the
    28 rows of scores.csv; then each kernel against its plain version on
    the first inputs of each shape the sweep gave it."""
    import shutil

    import pandas as pd
    import torch

    from peppa_tpu_torch import ablation_sweep
    from peppa_tpu_torch.config import conditions, default_config
    from peppa_tpu_torch.evaluation import evaluation
    from peppa_tpu_torch.models import wav2vec2
    from peppa_tpu_torch.ops import loss as loss_op
    from peppa_tpu_torch.ops.cuda import attention, loss
    from peppa_tpu_torch.training import loop

    t_phase = time.perf_counter()
    record = {"profile": _profile_window(report, card, root), "fits": {},
              "plain": 0}
    work = tempfile.mkdtemp(prefix="chip_smoke_sweep_", dir=root)
    base = default_config()
    base.data.data_dir = os.path.join(work, "data")
    base.data.train.batch_size = base.data.val.batch_size = SWEEP_B
    base.training.max_epochs = 1
    base.training.limit_train_batches = SWEEP_TRAIN_BATCHES
    base.training.limit_val_batches = SWEEP_VAL_BATCHES
    base.training.num_sanity_val_steps = 0
    base.training.accumulate_grad_batches = 1
    names = list(conditions(base))

    def fit(real):
        def run(trainer, data, *a, **kw):
            name = names[len(record["fits"])]
            _reset_counts()
            t0 = time.perf_counter()
            state = real(trainer, data, *a, **kw)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            record["fits"][name] = {"s": s, "launches": _counts(),
                                    "steps": state.step}
            report["launches"][f"sweep_{name}"] = _counts()
            print(f"4s fit {name}: {s:.1f} s, {state.step} micro-steps, "
                  f"launches {_counts()}")
            return state
        return run

    def scoring(real):
        def run(*a, **kw):
            _reset_counts()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            record["scoring"] = {"s": time.perf_counter() - t0,
                                 "launches": _counts()}
            report["launches"]["sweep_scoring"] = _counts()
            return out
        return run

    inputs: dict = {}
    undo = [_patch(loop.Trainer, "fit", fit),
            _patch(evaluation, "full_run", scoring),
            _patch(wav2vec2, "mha_attention",
                   _kept_inputs(inputs, "attention")),
            _patch(loss_op, "fused_triplet_loss",
                   _kept_inputs(inputs, "triplet_loss"))]
    undo += [_patch({"attention": attention, "loss": loss}[m], name,
                    _count_on_card(record)) for m, name in PLAIN_VERSIONS]
    try:
        t0 = time.perf_counter()
        cond_map, results_dir = ablation_sweep.run_sweep(
            work, base=base, n_samples=SWEEP_SAMPLES,
            episodes_train=SWEEP_EPISODES_TRAIN,
            episodes_val=SWEEP_EPISODES_VAL)
        sweep_s = time.perf_counter() - t0
        scores = pd.read_csv(os.path.join(results_dir, "scores.csv"))
        tex = [os.path.exists(os.path.join(results_dir, f))
               for f in ablation_sweep.ARTIFACTS[1:]]
    finally:
        for u in reversed(undo):
            u()
        shutil.rmtree(work, ignore_errors=True)
    versions = [v for vals in cond_map.values() for v in vals]
    print(f"4s sweep: {len(names)} conditions trained and scored in "
          f"{sweep_s:.1f} s (scoring {record['scoring']['s']:.1f} s, "
          f"launches {record['scoring']['launches']}); conditions.yaml "
          f"{cond_map}; scores.csv {len(scores)} rows; plain versions on "
          f"the card {record['plain']} ({card})")
    if sorted(cond_map) != sorted(names) or len(versions) != len(names) \
            or len(set(versions)) != len(names):
        raise AssertionError(f"4s: conditions.yaml {cond_map}")
    if len(scores) != 4 * len(names) or not all(tex):
        raise AssertionError(f"4s: {len(scores)} score rows, tables {tex}")
    if set(scores.version) != set(versions) or record["plain"]:
        raise AssertionError(f"4s: versions {set(scores.version)}, plain "
                             f"calls {record['plain']}")
    for name, fit_record in record["fits"].items():
        # the defaults' dropout: the plain attention route in the
        # micro-steps, kernel 1 in validation (12 a batch), kernel 3 in
        # both
        n = fit_record["launches"]
        if fit_record["steps"] != SWEEP_TRAIN_BATCHES \
                or n["attention_bwd"] != 0 or n["attention_fwd"] == 0 \
                or n["attention_fwd"] % 12 \
                or n["triplet_loss"] <= SWEEP_TRAIN_BATCHES:
            raise AssertionError(f"4s fit {name}: {fit_record}")
    n = record["scoring"]["launches"]  # the battery: kernel 1 alone
    if n["attention_fwd"] == 0 or n["attention_bwd"] or n["triplet_loss"]:
        raise AssertionError(f"4s scoring: {record['scoring']}")
    _hold_path_shapes(report, inputs, tag="sweep_shapes", each=False)
    record.update(sweep_s=sweep_s, rows=len(scores), conditions=cond_map,
                  phase_s=time.perf_counter() - t_phase)
    print(f"4s: phase in {record['phase_s']:.1f} s")
    report["sweep"] = record


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
                      kernels=("attention", "triplet_loss"),
                      each: bool = True) -> None:
    """Each kernel against its plain version on the inputs a path gave it,
    the first of each shape, at phase 2's tolerances: for the trainer's two
    fits (`trainer_shapes`), attention on every validation batch shape (the
    2.3 s fixed loaders at B = 8 and the remainder's B = 4, the 1, 2 and 3 s
    line clips at B up to 8), the loss at every eval batch size and the
    micro-step's (with its gradient); for the pipeline's fit and scorer
    (`pipeline_shapes`), the same over the episode tree's clips and
    lines; for the evaluation entry (`evaluation_shapes`) and the results
    path (`results_shapes`), attention at the shapes its paths gave it
    (`kernels`: the ones the path runs).  Without `each`, one line per
    kernel sums the shapes up."""
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
            if each:
                print(f"{tag.replace('_', ' ')}: {kernel} {list(shape)} "
                      f"{dtype}{' with the gradient' if grad else ''}: "
                      f"max|d|={err:.3g} against the plain version ({tol})")
            rows[kernel].append({"shape": list(shape), "dtype": dtype,
                                 "grad": grad, "max_abs_err": err})
    for kernel in rows:
        if not rows[kernel]:
            raise AssertionError(f"{tag}: {kernel} was given no inputs")
        if not each:
            worst = max(rows[kernel], key=lambda r: r["max_abs_err"])
            print(f"{tag.replace('_', ' ')}: {kernel} on "
                  f"{len(rows[kernel])} shapes (dtypes "
                  f"{sorted({r['dtype'] for r in rows[kernel]})}): worst "
                  f"max|d|={worst['max_abs_err']:.3g} at {worst['shape']} "
                  f"{worst['dtype']} against the plain version "
                  f"({TOL_ATTN})")
        held = report.setdefault(kernel, {"max_abs_err": 0.0})  # --phases
        held[tag] = rows[kernel]
        held["max_abs_err"] = max(
            [held["max_abs_err"]]
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


def _write_pipeline_tree(cfg) -> tuple:
    """The episode tree of PIPELINE_EPISODES under cfg.data.data_dir, at
    the config's frame size and sample rate: (seconds, bytes)."""
    from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree

    d = cfg.data
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
    return tree_s, tree_bytes


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
        tree_s, tree_bytes = _write_pipeline_tree(cfg)

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
        scorer = TripletScorer("dialog", ["val"], target_size=d.target_size,
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
    if not os.path.isdir(cfg.data.data_dir):  # phase 6 without 4d
        _write_pipeline_tree(cfg)
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


# ------------------------------------------------------------------ phase 7
# the host packages the results path imports inside its functions
RESULTS_PACKAGES = ("pandas", "scipy", "sklearn", "matplotlib", "Levenshtein",
                    "yaml", "jinja2")
# each step of phase 7 and the host packages it needs beyond torch and
# numpy, in the order the phase takes them; a step whose packages are not
# all installed is left out, and named
RESULTS_STEPS = (
    ("grsa.Embedder.embed", ()),
    ("grsa.main", ("pandas", "Levenshtein")),  # words carry phonemes
    ("grsa.pairwise multiword", ()),  # utterances carry none
    ("grsa.embed_utterances", ()),
    ("grsa.unpairwise", ("pandas", "scipy", "Levenshtein", "matplotlib")),
    ("stats.main", ("pandas", "scipy", "matplotlib", "Levenshtein")),
    ("grsa.word_type", ("pandas",)),
    ("grsa.vanilla_rsa", ("pandas",)),
    ("grsa.probe", ("pandas", "sklearn")),
    ("duration_effect", ()),
    ("duration_effect_scramble", ()),
    ("test_run", ()),
    ("merge_scores", ()),
    ("format_tables", ("pandas", "jinja2")),
    ("test_table", ("pandas", "jinja2")),
    ("plots", ("pandas", "matplotlib")),
    ("recall_at_1_to_n_plot", ("matplotlib",)),
    ("duration_effect_plot", ("pandas", "matplotlib")),
    ("targeted_eval --plot", ("pandas", "scipy", "matplotlib", "jinja2")),
    ("targeted_eval.create_results_table", ("pandas", "jinja2")),
)
# the realign tree: 44.1 kHz utterances of 1-4 s, 2-6 words each
REALIGN_EPISODES = {"dialog": (197, 198, 199, 200), "narration": (1, 2, 3, 4)}
REALIGN_PER_EPISODE = 5
REALIGN_RATE = 44100  # UttData's rate, whatever the run's config says
REALIGN_LEXICON = {
    "peppa": "P EH1 P AH0", "george": "JH AO1 R JH", "muddy": "M AH1 D IY0",
    "puddle": "P AH1 D AH0 L", "jump": "JH AH1 M P", "daddy": "D AE1 D IY0",
    "mummy": "M AH1 M IY0", "pig": "P IH1 G", "big": "B IH1 G",
    "house": "HH AW1 S", "run": "R AH1 N", "dinosaur": "D AY1 N AH0 S AO2 R",
    "rabbit": "R AE1 B AH0 T", "garden": "G AA1 R D AH0 N",
    "splash": "S P L AE1 SH", "happy": "HH AE1 P IY0", "teddy": "T EH1 D IY0",
    "boots": "B UW1 T S", "rain": "R EY1 N", "play": "P L EY1"}
REALIGN_SPEAKERS = ("Peppa", "George", "Daddy Pig", "Mummy Pig")
RESULTS_CONDITIONS = {"base": [0], "pretraining_a": [1], "static": [2],
                      "pretraining_v": [], "pretraining_none": [],
                      "freeze_wav2vec": [], "jitter": []}
# Embedder.embed's stages, in the order it encodes them, and their taps
STAGES = ("untrained", "trained", "project", "wav2vec", "conv")
STAGE_TAPS = {"untrained": "embedding", "trained": "embedding",
              "project": "embedding", "wav2vec": "context", "conv": "conv"}
TEST_EPISODES = (105, 106)  # narration test, for test_run


def _write_realign_tree(data_dir: str, rng, per_episode: int,
                        episodes=REALIGN_EPISODES) -> int:
    """{data_dir}/out/realign/{fragment}/ep_{N}/0/{i}.{wav,json}: mono
    16-bit WAV at REALIGN_RATE and gentle-style JSON (transcript, word
    spans at 10 ms, ARPAbet phones with position tags, a speaker: one of
    four on the dialog lines, "Narrator" on the narration ones); returns
    the number of words."""
    import json
    import wave

    import numpy as np

    words = sorted(REALIGN_LEXICON)
    n_words = 0
    for fragment, numbers in episodes.items():
        for ep in numbers:
            base = os.path.join(data_dir, "out", "realign", fragment,
                                f"ep_{ep}", "0")
            os.makedirs(base, exist_ok=True)
            for i in range(per_episode):
                n = int(rng.integers(2, 7))
                spans = rng.integers(20, 60, n) / 100.0  # 0.2-0.6 s
                gaps = rng.integers(0, 15, n) / 100.0
                t, entries = 0.05, []
                for j in range(n):
                    word = words[int(rng.integers(len(words)))]
                    arpa = REALIGN_LEXICON[word].split()
                    tags = (["B"] + ["I"] * (len(arpa) - 2) + ["E"])
                    entries.append({
                        "word": word, "alignedWord": word,
                        "case": "success", "start": round(t, 2),
                        "end": round(t + spans[j], 2),
                        "phones": [{"phone": f"{p.lower()}_{tag}",
                                    "duration": 0.05}
                                   for p, tag in zip(arpa, tags)]})
                    t += spans[j] + gaps[j]
                total = max(t + 0.05, 1.0)
                speaker = (REALIGN_SPEAKERS[int(rng.integers(4))]
                           if fragment == "dialog" else "Narrator")
                meta = {"transcript": " ".join(e["word"] for e in entries),
                        "words": entries, "speaker": speaker}
                stem = os.path.join(base, str(i))
                with open(stem + ".json", "w") as f:
                    json.dump(meta, f)
                tt = np.arange(int(total * REALIGN_RATE)) / REALIGN_RATE
                audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
                         + 0.05 * rng.standard_normal(len(tt)))
                with wave.open(stem + ".wav", "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(REALIGN_RATE)
                    w.writeframes((audio * 32767).astype("<i2").tobytes())
                n_words += n
    return n_words


def _counted_encode(record: dict):
    """A wrapper of `grsa._encode` that appends (tap, batches, kernel 1
    launches) of each call to record["encode"]."""
    from peppa_tpu_torch.ops.cuda.attention import mha_attention

    def wrap(real):
        def run(model, batches, tap="embedding", pool_time=False):
            batches = list(batches)
            before = mha_attention.launches
            out = real(model, batches, tap, pool_time)
            record["encode"].append((tap, len(batches),
                                     mha_attention.launches - before))
            return out
        return run
    return wrap


def _results_runs(root: str, cfg) -> tuple:
    """Phase 6's JAX-format and port run directories as versions 0 and 1
    of one log directory (links), a static run directory written as
    version 2, and a float32 copy of version 1's config and weights as
    version 3 (for the card against the CPU); conditions.yaml naming 0,
    1 and 2.  Returns (log_dir, conditions path)."""
    import yaml

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.training.checkpoint import save_checkpoint
    from peppa_tpu_torch.training.state import TrainState

    log_dir = os.path.join(root, "runs7")
    os.makedirs(log_dir)
    for version, kind in ((0, "jax"), (1, "port")):
        os.symlink(os.path.join(root, "runs", kind, "version_0"),
                   os.path.join(log_dir, f"version_{version}"))
    static, fp32 = default_config(), default_config()
    static.video.static = True
    fp32.training.precision = "fp32"
    for version, config, seed in ((2, static, 2), (3, fp32, 0)):
        config.data.data_dir = cfg.data.data_dir
        model = init_model(config, seed=seed)
        vdir = os.path.join(log_dir, f"version_{version}")
        path = os.path.join(vdir, "checkpoints",
                            "epoch=0-valnarr_triplet=0.50.ckpt")
        os.makedirs(os.path.dirname(path))
        config.dump(os.path.join(vdir, "hparams.yaml"))
        save_checkpoint(path, TrainState.create(model, config),
                        dict(RUN_META, best_model_path=path))
        del model
    conditions = os.path.join(root, "conditions.yaml")
    with open(conditions, "w") as f:
        yaml.safe_dump(RESULTS_CONDITIONS, f)
    return log_dir, conditions


def _embedder_card_vs_cpu(log_dir: str, data_dir: str) -> float:
    """`Embedder.embed`'s five stages of the float32 run (version 3) on a
    few utterances, on the card and on the CPU, with the TF32 settings a
    user process has: the largest difference, which must stay within
    EMB_TOL (every stage is printed before a failure raises)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.analysis import grsa

    out = {}
    for device in ("cuda", "cpu"):
        e = grsa.Embedder(3, log_dir, data_dir)
        e.load_audio()
        e.embed(device=device)
        out[device] = e.embedding
    print(f"results: Embedder card vs CPU, {tf32_line()}")
    worst, failed = 0.0, []
    for fragment_type, stages in out["cpu"].items():
        for stage, want in stages.items():
            got = out["cuda"][fragment_type][stage]
            err = float(np.abs(got - want).max())
            print(f"results: Embedder {fragment_type} {stage} {got.shape}, "
                  f"float32, card vs CPU: max|d|={err:.3g} (tol {EMB_TOL})")
            if not err <= EMB_TOL:
                failed.append(f"{stage} {err:.3g}")
            worst = max(worst, err)
    if failed:
        raise AssertionError(f"Embedder card vs CPU: {failed}")
    return worst


def run_results(report: dict, card: str, root: str) -> None:
    """The results path at full width (`hparams_base.yaml`, bf16, seeded
    weights) on a realign tree written under phase 4d's episode tree
    (module doc, phase 7): the GRSA analysis (`Embedder`'s five stages,
    `pairwise`, `embed_utterances`, the RSA, probe and regression steps),
    the duration effects over phase 6's run directories and a static one,
    `test_run`, and the tables and figures over the score files; each
    step whose host packages are installed (RESULTS_STEPS).  Kernel 1's
    launches per path and per Embedder stage (none on 'conv'), no plain
    version on the card; `Embedder` card against CPU in float32; kernel 1
    against its plain version on each shape the path gave it."""
    import contextlib
    import csv
    import importlib.util

    import numpy as np
    import torch

    from peppa_tpu_torch import targeted_eval
    from peppa_tpu_torch.analysis import grsa, plotting, stats
    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
    from peppa_tpu_torch.evaluation import evaluation
    from peppa_tpu_torch.models import wav2vec2
    from peppa_tpu_torch.ops.cuda import attention, loss

    t_phase = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None
            for m in RESULTS_PACKAGES}
    print(f"results: host packages installed {have}")
    run, left_out = [], {}
    for name, needs in RESULTS_STEPS:
        missing = [m for m in needs if not have[m]]
        if missing:
            left_out[name] = missing
            print(f"results: {name} left out: {', '.join(missing)} not "
                  "installed")
        else:
            run.append(name)

    cfg = default_config()
    cfg.data.data_dir = os.path.join(root, "data")  # phase 4d's tree
    data_dir = cfg.data.data_dir
    results = os.path.join(root, "results")  # phase 6's score files
    results7 = os.path.join(root, "results7")
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    n_words = _write_realign_tree(data_dir, rng, REALIGN_PER_EPISODE)
    small = os.path.join(root, "data_small")
    _write_realign_tree(small, rng, 1, {"dialog": (197,),
                                         "narration": (1,)})
    w, h = cfg.data.target_size
    make_synthetic_episode_tree(
        data_dir, target_size=(w, h), fragment_type="narration",
        episodes=TEST_EPISODES, clips_per_episode=PIPELINE_CLIPS,
        clip_seconds=PIPELINE_CLIP_S, sample_rate=cfg.data.audio_sample_rate,
        seed=1, correlated=True)
    log_dir, conditions = _results_runs(root, cfg)
    n_utts = (sum(map(len, REALIGN_EPISODES.values()))
              * REALIGN_PER_EPISODE)
    print(f"results: realign tree of {n_utts} utterances ({n_words} words) "
          f"at {REALIGN_RATE} Hz, narration test episodes {TEST_EPISODES}, "
          f"a static and a float32 run directory, written in "
          f"{time.perf_counter() - t0:.1f} s")

    n_layers = cfg.audio.num_layers or 12
    record = {"plain": 0, "encode": []}
    inputs: dict = {}
    stats_out = {"steps_s": {}, "left_out": left_out}
    modules = {"attention": attention, "loss": loss}
    undo = [_patch(modules[m], name, _count_on_card(record))
            for m, name in PLAIN_VERSIONS]
    undo.append(_patch(grsa, "_encode", _counted_encode(record)))
    undo.append(_patch(wav2vec2, "mha_attention",
                       _kept_inputs(inputs, "attention")))

    @contextlib.contextmanager
    def step(name, path=None):
        """Time a step; with `path`, its launches are that path's."""
        record["encode"] = []
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stats_out["steps_s"][name] = time.perf_counter() - t0
        launches = _counts()
        if path is not None:
            report["launches"][path] = launches
        print(f"results: {name} in {stats_out['steps_s'][name]:.2f} s; "
              f"launches {launches}")
        if launches["attention_bwd"] or launches["triplet_loss"]:
            raise AssertionError(f"{name}: {launches}")

    embedder = None
    try:
        if "grsa.Embedder.embed" in run:
            with step("grsa.Embedder.embed", "results_embedder"):
                embedder = grsa.Embedder(0, log_dir, data_dir)
                embedder.load_audio()
                embedder.embed()
            calls = record["encode"]
            if len(calls) != 2 * len(STAGES):
                raise AssertionError(f"Embedder encodes {calls}")
            per_stage = {s: [0, 0] for s in STAGES}
            for i, (tap, batches, launches) in enumerate(calls):
                stage = STAGES[i % len(STAGES)]
                if tap != STAGE_TAPS[stage]:
                    raise AssertionError(f"call {i}: tap {tap} for {stage}")
                per_stage[stage][0] += batches
                per_stage[stage][1] += launches
            for stage, (batches, launches) in per_stage.items():
                want = 0 if stage == "conv" else n_layers * batches
                print(f"results: Embedder stage {stage}: {batches} "
                      f"batches, kernel 1 launches {launches} "
                      f"(expected {want})")
                if launches != want or (stage != "conv"
                                        and not launches):
                    raise AssertionError(f"stage {stage}: {launches}")
            stats_out["stage_launches"] = {
                s: v[1] for s, v in per_stage.items()}
            for fragment_type, stages in embedder.embedding.items():
                for stage, x in stages.items():
                    if x.shape[0] != len(embedder.audio[fragment_type]) \
                            or not np.isfinite(x).all():
                        raise AssertionError(f"{fragment_type} {stage}")
                for stage in ("untrained", "trained", "project"):
                    norm = np.linalg.norm(stages[stage], axis=1)
                    if not np.abs(norm - 1).max() <= 1e-2:
                        raise AssertionError(f"{stage} norms {norm}")
            with step("Embedder card vs CPU", "results_card_vs_cpu"):
                stats_out["card_vs_cpu_max_abs"] = \
                    _embedder_card_vs_cpu(log_dir, small)
        pairwise_csv = os.path.join(results7, "pairwise.csv")
        if "grsa.main" in run:
            with step("grsa.main", "results_grsa_main"):
                grsa.main([0], log_dir=log_dir, data_dir=data_dir,
                          out_csv=pairwise_csv)
        if "grsa.pairwise multiword" in run:
            with step("grsa.pairwise multiword", "results_pairwise"):
                for fragment_type in ("dialog", "narration"):
                    rows = list(grsa.pairwise(
                        0, fragment_type, multiword=True,
                        log_dir=log_dir, data_dir=data_dir))
                    n = n_utts // 2
                    sims = np.array([[r["sim_1"], r["sim_2"]]
                                     for r in rows])
                    if len(rows) != n * (n - 1) // 2 or not (
                            np.abs(sims) <= 1 + 1e-5).all():
                        raise AssertionError(f"pairwise {len(rows)}")
                stats_out["pairwise_records"] = len(rows)
        if "grsa.embed_utterances" in run:
            with step("grsa.embed_utterances",
                      "results_embed_utterances"):
                for fragment_type in ("dialog", "narration"):
                    utts = grsa.embed_utterances(
                        0, fragment_type, projection=True,
                        log_dir=log_dir, data_dir=data_dir)
                    if len(utts) != n_utts // 2 or not all(
                            np.isfinite(u.embedding_1).all()
                            and np.isfinite(u.embedding_2).all()
                            for u in utts):
                        raise AssertionError("embed_utterances")
        if "grsa.unpairwise" in run:
            with step("grsa.unpairwise", "results_unpairwise"):
                grsa.unpairwise(0, n_samples=5, log_dir=log_dir,
                                data_dir=data_dir, results_dir=results7)
        if "stats.main" in run:
            with step("stats.main"):
                stats.main(pairwise_csv, results7)
        if embedder is not None:
            for name, fn in (
                    ("grsa.word_type", lambda: grsa.word_type(
                        embedder, results7, data_dir)),
                    ("grsa.vanilla_rsa",
                     lambda: grsa.vanilla_rsa(embedder)),
                    ("grsa.probe", lambda: grsa.probe(embedder))):
                if name in run:
                    with step(name):
                        table = fn()
                    print(f"results: {name}: {table.to_dict('records')}")
        for name, fn in (("duration_effect", evaluation.duration_effect),
                         ("duration_effect_scramble",
                          evaluation.duration_effect_scramble)):
            if name in run:
                with step(name, f"results_{name}"):
                    fn(log_dir, results7, conditions)
                out = torch.load(os.path.join(results7, f"{name}.pt"),
                                 weights_only=False)
                for r in out:
                    if not (len(r["success"]) == 2 and all(
                            s.shape == r["duration"].shape
                            and np.isfinite(s).all()
                            for s in r["success"])):
                        raise AssertionError(f"{name} {r.keys()}")
                print(f"results: {name}: "
                      + "; ".join(f"{r['fragment_type']} "
                                  f"{r['duration'].shape[0]} targets, "
                                  f"mean success "
                                  f"{[float(s.mean()) for s in r['success']]}"
                                  for r in out))
        if "test_run" in run:
            with step("test_run", "results_test_run"):
                evaluation.test_run(log_dir, results, n_samples=EVAL_SAMPLES,
                                    conditions_path=conditions)
        if "merge_scores" in run:
            with step("merge_scores"):
                evaluation.merge_scores(None, results)
        for name, fn in (
                ("format_tables",
                 lambda: evaluation.format_tables(results)),
                ("test_table", lambda: evaluation.test_table(results)),
                ("plots", lambda: (
                    evaluation.full_run([1, 2], log_dir, results,
                                        EVAL_SAMPLES,
                                        conditions_path=conditions),
                    plotting.plots(conditions, results))),
                ("recall_at_1_to_n_plot",
                 lambda: plotting.recall_at_1_to_n_plot(results)),
                ("duration_effect_plot", lambda: (
                    plotting.duration_effect_plot(conditions, results7),
                    plotting.duration_effect_plot(conditions, results7,
                                                  scramble=True))),
                ("targeted_eval --plot", lambda: targeted_eval.main([
                    "--plot", "--versions", "0", "--results_dir",
                    os.path.join(results, "targeted"), "--data_dir",
                    data_dir, "--conditions", conditions])),
                ("targeted_eval.create_results_table",
                 lambda: targeted_eval.create_results_table(
                     os.path.join(results, "targeted"), conditions))):
            if name in run:
                with step(name, "results_plots" if name == "plots"
                          else None):
                    fn()
    finally:
        for u in undo:
            u()
    if record["plain"]:
        raise AssertionError(f"plain versions on the card: {record['plain']}")
    written = sorted(os.path.join(r, f) for d in (results, results7)
                     for r, _, fs in os.walk(d) for f in fs
                     if f.endswith((".csv", ".tex", ".pdf", ".png")))
    empty = [p for p in written if not os.path.getsize(p)]
    if empty:
        raise AssertionError(f"empty files {empty}")
    print(f"results: files written "
          f"{[os.path.relpath(p, root) for p in written]}")
    if os.path.exists(os.path.join(results, "scores.csv")):
        with open(os.path.join(results, "scores.csv")) as f:
            table = list(csv.DictReader(f))
        if len(table) != 4:
            raise AssertionError(f"scores.csv rows {len(table)}")
    t_values = sorted({k[1][1] for k in inputs})
    launches = sum(c["attention_fwd"] for p, c in report["launches"].items()
                   if p.startswith("results_"))
    print(f"results: kernel 1 launches {launches} over "
          f"{len(t_values)} distinct T ({t_values[0]}-{t_values[-1]}) "
          f"in {len(inputs)} distinct shapes")
    stats_out.update(kernel1_launches=launches, distinct_t=len(t_values),
                     distinct_shapes=len(inputs),
                     phase_s=time.perf_counter() - t_phase)
    _hold_path_shapes(report, inputs, "results_shapes",
                      kernels=("attention",), each=False)
    report["results"] = stats_out
    print(f"results: seconds per step {stats_out['steps_s']} ({card})")


# ------------------------------------------------------------------ phase 8
# the raw episodes: narration val 1-4 and dialog val 197-200, 60 s each,
# 25 fps at 240x136 (above the 180x100 target), 44.1 kHz PCM in an .avi
PREP_EPISODES = {"narration": (1, 2, 3, 4), "dialog": (197, 198, 199, 200)}
PREP_SECONDS, PREP_FPS, PREP_SIZE, PREP_RATE = 60.0, 25, (240, 136), 44100
PREP_PARTS = 3  # parts per episode, 4 lines each
# a subtitle line's length (s): one short (the 2 s bucket with its 1 s of
# margins), ten of 1.5-3.5 s (4 and 8 s), one long (16 s)
PREP_LINES = ((0.6, 0.9),) + ((1.5, 3.5),) * 5 + ((9.0, 14.0),) \
    + ((1.5, 3.5),) * 5
# the lines' template "{subject} {verb} in the {adjective} puddles": one
# word pair per tag (NOUN, VERB, ADJ), each word in a sixth of the
# narration lines (dealt from a shuffled deck), the rest words the tagger
# puts under no tag of the eval sets (X, AUX, ADV), so that each set
# holds about eight minimal pairs
PREP_SLOTS = (("peppa", "george", "she", "she", "he", "he"),
              ("jumps", "runs", "is", "is", "is", "is"),
              ("big", "little", "really", "really", "very", "very"))
PREP_MIN_OCCURRENCES = 3  # generate's --min-occurrences (corpus: 10)
ALIGN_LAYERS = 12  # the aligner's wav2vec2-base: kernel 1 per layer
ALIGN_BUCKETS = (2.0, 4.0, 8.0, 16.0)
ALIGN_T = (99, 199, 399, 799)  # the buckets' frames
# human_check's export steps and the host packages each needs
PREP_STEPS = (("human_check.export_triplets", ("cv2",)),
              ("human_check.export_targeted_word", ("cv2",)))


def _stamp(t: float) -> str:
    """H:MM:SS, or H:MM:SS.fff off a whole second."""
    ms = int(round(t * 1000))
    h, rest = divmod(ms, 3600_000)
    m, rest = divmod(rest, 60_000)
    s, frac = divmod(rest, 1000)
    return f"{h}:{m:02d}:{s:02d}" + (f".{frac:03d}" if frac else "")


def _write_raw_episodes(data_dir: str, rng) -> tuple:
    """data/in in the reference's layout: the episode list CSV, one
    annotation JSON per episode (its lines in its fragment's key, as
    `subtitles` with a speaker on dialog lines and as word-level
    `tokenized` spans; the other key empty), and the media as .avi
    (cv2 mpeg4 + PCM16).  Returns the number of lines."""
    import json

    import numpy as np

    from peppa_tpu_torch.data.avi import write_clip_avi

    n_narration = len(PREP_EPISODES["narration"]) * len(PREP_LINES)
    decks = [list(rng.permutation(slot * (n_narration // len(slot))))
             for slot in PREP_SLOTS]
    pick = lambda words: words[int(rng.integers(len(words)))]  # noqa: E731
    ep_dir = os.path.join(data_dir, "in", "peppa", "episodes")
    os.makedirs(ep_dir)
    listing, n_lines = [], 0
    w, h = PREP_SIZE
    n_frames = int(PREP_SECONDS * PREP_FPS)
    yy, xx = np.mgrid[0:h, 0:w]
    for fragment, numbers in PREP_EPISODES.items():
        key = "narration" if fragment == "narration" else "context"
        for epid in numbers:
            title = f"Episode {epid}"
            listing.append(f"{epid};'{title}';'mnt/ep_{epid}.avi'\n")
            parts, t = [], 0.5
            per_part = len(PREP_LINES) // PREP_PARTS
            for p in range(PREP_PARTS):
                subtitles, tokenized = [], []
                for lo, hi in PREP_LINES[p * per_part:(p + 1) * per_part]:
                    length = round(float(rng.uniform(lo, hi)), 2)
                    subject, verb, adjective = (
                        [str(deck.pop()) for deck in decks]
                        if fragment == "narration"
                        else map(pick, PREP_SLOTS))
                    words = [subject, verb, "in", "the", adjective,
                             "puddles"]
                    sub = {"text": " ".join(words), "begin": _stamp(t),
                           "end": _stamp(t + length)}
                    if fragment == "dialog":
                        sub["speaker"] = REALIGN_SPEAKERS[
                            int(rng.integers(len(REALIGN_SPEAKERS)))]
                    subtitles.append(sub)
                    step = length / len(words)
                    tokenized += [{"token": word,
                                   "begin": _stamp(t + k * step),
                                   "end": _stamp(t + (k + 1) * step)}
                                  for k, word in enumerate(words)]
                    t += length + 0.5
                    n_lines += 1
                empty = {"subtitles": [], "tokenized": []}
                part = {"context": empty, "narration": empty}
                part[key] = {"subtitles": subtitles, "tokenized": tokenized}
                parts.append(part)
            if t > PREP_SECONDS:
                raise AssertionError(f"episode {epid}: lines end at {t} s")
            with open(os.path.join(ep_dir, f"ep_{epid}.json"), "w") as f:
                json.dump({"id": epid, "title": title,
                           "narrator_splits": parts}, f)
            # a colour ramp over time and a bar moving across the frame
            video = np.empty((n_frames, h, w, 3), np.uint8)
            for i in range(n_frames):
                video[i] = (xx[..., None] + yy[..., None] // 2 + 3 * i
                            + np.array([0, 85, 170])) % 256
                bar = (4 * i) % w
                video[i, :, bar:bar + 12] = 255
            tt = np.arange(int(PREP_SECONDS * PREP_RATE)) / PREP_RATE
            audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
                     + 0.05 * rng.standard_normal(len(tt))).astype(np.float32)
            write_clip_avi(os.path.join(data_dir, "in", "peppa",
                                        f"ep_{epid}.avi"),
                           video, audio, fps=PREP_FPS, rate=PREP_RATE)
    with open(os.path.join(data_dir, "in",
                           "peppa_pig_dataset-video_list.csv"), "w") as f:
        f.writelines(listing)
    return n_lines


def _aligner_variables():
    """The aligner's wav2vec2-base (float32, full width and depth, the
    28-d aux head) from seeded random weights, as the JAX-layout tree
    `make_ctc_logits_fn` takes."""
    import torch

    from peppa_tpu_torch.models.convert import export_jax_variables
    from peppa_tpu_torch.models.dual_encoder import _init_parameters
    from peppa_tpu_torch.models.wav2vec2 import Wav2Vec2

    model = Wav2Vec2()
    _init_parameters(model, torch.Generator().manual_seed(8))
    return export_jax_variables(model)


def _bucket_utterances(data_dir: str) -> dict:
    """One realigned wav per bucket (the first of each in file order):
    bucket -> (wav path, its JSON)."""
    import glob
    import json
    import wave

    out = {}
    for path in sorted(glob.glob(os.path.join(
            data_dir, "out", "realign", "*", "ep_*", "*", "*.wav"))):
        with wave.open(path) as w:
            seconds = w.getnframes() / w.getframerate()
        bucket = next(b for b in ALIGN_BUCKETS if seconds <= b)
        if bucket not in out:
            with open(path[:-4] + ".json") as f:
                out[bucket] = (path, json.load(f))
    if sorted(out) != list(ALIGN_BUCKETS):
        raise AssertionError(f"utterances in buckets {sorted(out)}")
    return out


def _aligner_forward_ms(variables, data_dir: str) -> dict:
    """The aligner's forward on the card (decode, pad, forward, log-softmax,
    copy back), one utterance per bucket, alone: the median of 5 after 1,
    host clock to the copy back.  bucket -> ms."""
    import numpy as np

    from peppa_tpu_torch.preprocess import forced_align as F

    fn = F.make_ctc_logits_fn(variables=variables)
    out = {}
    for bucket, (path, _) in sorted(_bucket_utterances(data_dir).items()):
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            fn(path)
            times.append(time.perf_counter() - t0)
        out[bucket] = float(np.median(times[1:])) * 1e3
    print(f"prep: the aligner's forward alone (decode to log-probs on the "
          f"host), ms per bucket: {out}")
    return out


def _aligner_card_vs_cpu(variables, data_dir: str) -> dict:
    """The aligner's log-probs of one utterance per bucket of 2, 4 and 8 s
    in float32 on the card (TF32 as a user process has it) and on the
    CPU, within EMB_TOL; the
    alignments of the two equal (words, timings, the JSON but the
    log-likelihood, which is compared within the frames' tolerance); the
    native DP equal to `_ctc_align_python` bit for bit on the card's."""
    import numpy as np
    import torch

    from peppa_tpu_torch.preprocess import forced_align as F

    utts = {b: u for b, u in _bucket_utterances(data_dir).items()
            if b <= 8.0}
    lps = {}
    for device in (None, "cpu"):
        fn = F.make_ctc_logits_fn(variables=variables, device=device)
        lps[device] = {b: fn(path) for b, (path, _) in utts.items()}
    print(f"prep: CTC log-probs card vs CPU, {tf32_line()}")
    worst, failed = 0.0, []
    for bucket, (path, meta) in utts.items():
        card, cpu = lps[None][bucket], lps["cpu"][bucket]
        err = float(np.abs(card - cpu).max())
        worst = max(worst, err)
        print(f"prep: CTC log-probs {card.shape} ({bucket:g} s bucket), "
              f"float32, card vs CPU: max|d|={err:.3g} (tol {EMB_TOL})")
        if not err <= EMB_TOL:
            failed.append(f"log-probs {bucket:g} s: {err:.3g}")
        transcript = meta["transcript"]
        got = F.align_ctc(card, transcript, 320 / F.ALIGN_RATE)
        want = F.align_ctc(cpu, transcript, 320 / F.ALIGN_RATE)
        margin = got.get("log_likelihood", 0.0) - want.get(
            "log_likelihood", 0.0)
        lik_ok = abs(margin) <= EMB_TOL * card.shape[0]
        got.pop("log_likelihood", None)
        want.pop("log_likelihood", None)
        if got != want or not lik_ok:
            print(f"prep: alignments differ; the DP's path score card "
                  f"minus CPU {margin:.6g}")
            failed.append(f"alignment of {path}")
            continue
        tokens, _ = F.text_to_tokens(transcript)
        native = F.ctc_forced_align(card, tokens)
        plain = F._ctc_align_python(card, tokens)
        if not (np.array_equal(native[0], plain[0])
                and native[1] == plain[1]):
            raise AssertionError(f"native DP vs Python DP on {path}")
        print(f"prep: {len(got['words'])} words aligned alike from the "
              f"card's and the CPU's log-probs (path scores {margin:.3g} "
              f"apart); the native DP equals the Python DP bit for bit "
              f"(score {native[1]!r})")
    if failed:
        raise AssertionError(f"aligner card vs CPU: {failed}")
    return {"max_abs": worst, "buckets": sorted(utts)}


def _realign_threads_alike(variables, data_dir: str, root: str) -> int:
    """realign of one narration episode with nthreads 1 and 8: the same
    files, byte for byte; returns their number."""
    from peppa_tpu_torch.preprocess import forced_align as F

    one = os.path.join(root, "prep_one")
    src = os.path.join(data_dir, "in")
    dst = os.path.join(one, "in")
    epid = PREP_EPISODES["narration"][0]
    os.makedirs(os.path.join(dst, "peppa", "episodes"))
    shutil.copy(os.path.join(src, "peppa", "episodes", f"ep_{epid}.json"),
                os.path.join(dst, "peppa", "episodes"))
    os.symlink(os.path.join(src, "peppa", f"ep_{epid}.avi"),
               os.path.join(dst, "peppa", f"ep_{epid}.avi"))
    with open(os.path.join(src, "peppa_pig_dataset-video_list.csv")) as f:
        line = next(x for x in f if x.startswith(f"{epid};"))
    with open(os.path.join(dst, "peppa_pig_dataset-video_list.csv"),
              "w") as f:
        f.write(line)
    fn = F.make_ctc_logits_fn(variables=variables)
    trees = []
    for nthreads in (1, 8):
        F.realign("narration", data_dir=one, ctc_logits_fn=fn,
                  nthreads=nthreads)
        out = os.path.join(one, "out", "realign")
        files = {}
        for r, _, names in os.walk(out):
            for name in names:
                with open(os.path.join(r, name), "rb") as f:
                    files[os.path.relpath(os.path.join(r, name), out)] = \
                        f.read()
        trees.append(files)
        shutil.rmtree(out)
    if trees[0] != trees[1] or not trees[0]:
        raise AssertionError("realign with 1 and 8 threads wrote "
                             "different files")
    print(f"prep: realign of episode {epid} with 1 and with 8 threads: "
          f"{len(trees[0])} files (wav and JSON), byte for byte the same")
    return len(trees[0])


def aligner_attention_times(report: dict) -> list:
    """Kernel 1 in float32 at the aligner's shapes (B=1, T of each bucket,
    key length T - 1), by `f32_attention_times`; rows added to the
    kernel's `shapes`."""
    rows = [{**f32_attention_times(1, t, t - 1), "path": "prep_realign"}
            for t in ALIGN_T]
    held = report.setdefault("attention", {"max_abs_err": 0.0})
    held.setdefault("shapes", []).extend(rows)
    return rows


def run_prep(report: dict, card: str, root: str) -> None:
    """The corpus-preparation path (module doc, phase 8) on raw episodes it
    writes: extraction through `PigData.prepare_data`, `realign` with the
    port's wav2vec2 CTC model on the card (kernel 1 with key lengths, 12
    launches per utterance), `extract_realines`, the eval sets through
    `python -m peppa_tpu_torch.generate_eval_sets`, `targeted_eval --run`
    on them, and human_check's exports; then the checks."""
    import csv
    import glob
    import importlib.util
    import logging

    import numpy as np
    import torch

    from peppa_tpu_torch import generate_eval_sets, targeted_eval
    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.data.datamodule import PigData
    from peppa_tpu_torch.evaluation import eval_set_generation as G
    from peppa_tpu_torch.evaluation import evaluation, human_check
    from peppa_tpu_torch.models import wav2vec2
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.cuda import attention, loss
    from peppa_tpu_torch.preprocess import forced_align as F
    from peppa_tpu_torch.preprocess.extract import extract_realines
    from peppa_tpu_torch.training.checkpoint import save_checkpoint
    from peppa_tpu_torch.training.state import TrainState

    t_phase = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None
            for m in sorted({p for _, ps in PREP_STEPS for p in ps})}
    steps = [name for name, needs in PREP_STEPS
             if all(have[m] for m in needs)]
    for name, needs in PREP_STEPS:
        if name not in steps:
            print(f"prep: {name} left out: "
                  f"{', '.join(m for m in needs if not have[m])} not "
                  "installed")
    cfg = default_config()
    data_dir = cfg.data.data_dir = os.path.join(root, "prep", "data")
    cfg.data.extract, cfg.data.prepare = True, False
    stats: dict = {"steps_s": {}}
    rng = np.random.default_rng(8)
    t0 = time.perf_counter()
    stats["lines"] = _write_raw_episodes(data_dir, rng)
    stats["steps_s"]["raw_episodes"] = time.perf_counter() - t0
    print(f"prep: raw episodes {PREP_EPISODES} of {PREP_SECONDS:g} s "
          f"({PREP_SIZE[0]}x{PREP_SIZE[1]}, {PREP_FPS} fps, mpeg4 + "
          f"{PREP_RATE} Hz PCM .avi), {stats['lines']} subtitle lines, "
          f"written in {stats['steps_s']['raw_episodes']:.1f} s")

    # extraction, through the data module
    t0 = time.perf_counter()
    PigData(cfg).prepare_data()
    stats["steps_s"]["extract"] = time.perf_counter() - t0
    w, h = cfg.data.target_size
    clips = glob.glob(os.path.join(data_dir, "out", f"{w}x{h}", "*", "*",
                                   "*.npz"))
    stats["clips"] = len(clips)
    stats["clip_bytes"] = sum(os.path.getsize(p) for p in clips)
    want_clips = sum(map(len, PREP_EPISODES.values())) * PREP_PARTS
    print(f"prep: PigData.prepare_data (data.extract) in "
          f"{stats['steps_s']['extract']:.1f} s: {len(clips)} clips at "
          f"{w}x{h}, {stats['clip_bytes']} bytes")
    if len(clips) != want_clips:
        raise AssertionError(f"{len(clips)} clips, expected {want_clips}")
    with np.load(clips[0]) as z:
        if z["video"].shape[1:] != (h, w, 3) or not z["audio"].size:
            raise AssertionError(f"clip {clips[0]}: {z['video'].shape}")

    # realign on the card
    variables = _aligner_variables()
    # the forward's and the DP's seconds per call (from the pool's threads)
    record = {"plain": 0, "forward_s": [], "dp_s": []}
    inputs: dict = {}
    modules = {"attention": attention, "loss": loss}
    undo = [_patch(modules[m], name, _count_on_card(record))
            for m, name in PLAIN_VERSIONS]
    undo.append(_patch(wav2vec2, "mha_attention",
                       _kept_inputs(inputs, "attention")))
    undo.append(_patch(F, "ctc_forced_align", _timed(record, "dp_s")))
    nthreads = os.cpu_count() or 1
    t0 = time.perf_counter()
    F._native_align_lib()  # g++ of the DP, before the timed pool
    stats["dp_build_s"] = time.perf_counter() - t0
    try:
        fn = _timed(record, "forward_s")(
            F.make_ctc_logits_fn(variables=variables))
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fragment in ("narration", "dialog"):
            F.realign(fragment, data_dir=data_dir, ctc_logits_fn=fn,
                      nthreads=nthreads)
        torch.cuda.synchronize()
        stats["steps_s"]["realign"] = time.perf_counter() - t0
        launches = _counts()
        report["launches"]["prep_realign"] = launches
        jsons = glob.glob(os.path.join(data_dir, "out", "realign", "*",
                                       "ep_*", "*", "*.json"))
        n_utts = len(jsons)
        stats.update(utterances=n_utts, nthreads=nthreads,
                     forward_s=sum(record["forward_s"]),
                     dp_s=sum(record["dp_s"]))
        print(f"prep: realign (narration and dialog, val) of {n_utts} "
              f"utterances with {nthreads} threads in "
              f"{stats['steps_s']['realign']:.2f} s; the forwards "
              f"{stats['forward_s']:.2f} s and the DP "
              f"{stats['dp_s']:.3f} s, summed over the threads (the DP's "
              f"g++ build before, {stats['dp_build_s']:.1f} s); launches "
              f"{launches} (the counters take a lock per increment); plain "
              f"versions on the card {record['plain']}")
        want = {"attention_fwd": ALIGN_LAYERS * n_utts, "attention_bwd": 0,
                "triplet_loss": 0}
        if n_utts != stats["lines"] or launches != want or record["plain"]:
            raise AssertionError(f"realign: {n_utts} utterances of "
                                 f"{stats['lines']} lines, launches "
                                 f"{launches} != {want}, plain "
                                 f"{record['plain']}")
        t_seen = sorted({key[1][1] for key in inputs})
        if t_seen != list(ALIGN_T) or not all(key[4] for key in inputs):
            raise AssertionError(f"realign attention shapes {sorted(inputs)}")
        words = []
        for p in jsons:
            with open(p) as f:
                words += json.load(f)["words"]
        stats["words_aligned"] = sum(w["case"] == "success" for w in words)
        if stats["words_aligned"] != len(words):
            raise AssertionError(f"{len(words) - stats['words_aligned']} "
                                 "words not aligned")

        # the clips of the aligned spans, and the eval sets from them
        t0 = time.perf_counter()
        extract_realines(cfg.data.target_size, data_dir=data_dir)
        stats["steps_s"]["extract_realines"] = time.perf_counter() - t0
        realines = glob.glob(os.path.join(data_dir, "out", "realign", "*",
                                          "ep_*", "*", "*.npz"))
        if len(realines) != n_utts:
            raise AssertionError(f"{len(realines)} realigned clips")
        eval_dir = os.path.join(data_dir, "eval")
        tagger = G.make_tagger(G.default_annotations_dir(
            os.path.join(data_dir, "out", "realign")))
        t0 = time.perf_counter()
        level = logging.getLogger().level  # the CLIs set INFO
        try:
            generate_eval_sets.main([
                "--min-occurrences", str(PREP_MIN_OCCURRENCES),
                "--realign-dir", os.path.join(data_dir, "out", "realign"),
                "--eval-dir", eval_dir])
        finally:
            logging.getLogger().setLevel(level)
        stats["steps_s"]["generate"] = time.perf_counter() - t0
        stats["pairs"] = {}
        for pos in TARGETED_POS:
            with open(os.path.join(eval_dir,
                                   f"eval_set_narration_{pos}.csv")) as f:
                rows = list(csv.DictReader(f))
            stats["pairs"][pos] = len(rows) // 2
        stats["tagger"] = getattr(tagger, "__name__", type(tagger).__name__)
        print(f"prep: extract_realines {len(realines)} clips in "
              f"{stats['steps_s']['extract_realines']:.1f} s; eval sets "
              f"(python -m peppa_tpu_torch.generate_eval_sets "
              f"--min-occurrences {PREP_MIN_OCCURRENCES}) in "
              f"{stats['steps_s']['generate']:.1f} s: minimal pairs "
              f"{stats['pairs']}, tagger {stats['tagger']}")
        if not all(stats["pairs"].values()):
            raise AssertionError(f"empty eval sets {stats['pairs']}")

        # targeted_eval --run on the generated sets
        model = init_model(cfg, seed=0)
        log_dir = os.path.join(root, "runs8")
        vdir = os.path.join(log_dir, "version_0")
        path = os.path.join(vdir, "checkpoints",
                            "epoch=0-valnarr_triplet=0.50.ckpt")
        os.makedirs(os.path.dirname(path))
        cfg.dump(os.path.join(vdir, "hparams.yaml"))
        save_checkpoint(path, TrainState.create(model, cfg),
                        dict(RUN_META, best_model_path=path))
        del model
        predicted = {"batches": 0, "forward_s": 0.0}
        undo.append(_patch(evaluation, "make_predict",
                           _counted_predict(predicted)))
        results = os.path.join(root, "results8")
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            targeted_eval.main(["--run", "--versions", "0", "--log_dir",
                                log_dir, "--data_dir", data_dir,
                                "--results_dir", results])
            torch.cuda.synchronize()
        finally:
            logging.getLogger().setLevel(level)
        stats["steps_s"]["targeted_eval"] = time.perf_counter() - t0
        launches = _counts()
        report["launches"]["prep_targeted"] = launches
        stats["targeted_batches"] = predicted["batches"]
        stats["targeted_forward_s"] = predicted["forward_s"]
        want = {"attention_fwd": (cfg.audio.num_layers or 12)
                * predicted["batches"],
                "attention_bwd": 0, "triplet_loss": 0}
        print(f"prep: targeted_eval --run on the generated sets in "
              f"{stats['steps_s']['targeted_eval']:.1f} s: "
              f"{predicted['batches']} batches (their forwards "
              f"{predicted['forward_s']:.2f} s), launches {launches}")
        if launches != want or record["plain"] or not predicted["batches"]:
            raise AssertionError(f"targeted launches {launches} != {want}")
        with open(os.path.join(results, "version_0",
                               "minimal_pairs_scores.csv")) as f:
            table = list(csv.DictReader(f))
        n_rows = 2 * 2 * sum(stats["pairs"].values())  # scrambled or not
        scores = np.array([float(r["result"]) for r in table])
        if len(table) != n_rows or not np.isin(scores, (0.0, 1.0)).all():
            raise AssertionError(f"targeted rows {len(table)} != {n_rows}")
        stats["targeted_acc"] = float(scores.mean())

        # human_check's exports
        for name in steps:
            t0 = time.perf_counter()
            out_dir = os.path.join(root, "check8", name.split(".")[1])
            if name == "human_check.export_triplets":
                key = human_check.export_triplets(
                    out_dir, n=5, target_size=tuple(cfg.data.target_size),
                    audio_sample_rate=cfg.data.audio_sample_rate,
                    data_dir=data_dir)
                n = len(key)
            else:
                word = next(r["target_word"] for r in table
                            if r["pos"] == "NOUN")
                n = human_check.export_targeted_word(word, out_dir,
                                                     data_dir=data_dir)
            stats["steps_s"][name] = time.perf_counter() - t0
            files = [os.path.join(r, f) for r, _, fs in os.walk(out_dir)
                     for f in fs]
            print(f"prep: {name}: {n} exported, {len(files)} files in "
                  f"{stats['steps_s'][name]:.1f} s")
            if not n or not all(os.path.getsize(p) for p in files):
                raise AssertionError(f"{name}: {n} exported")
    finally:
        for u in undo:
            u()

    # the checks
    stats["forward_ms"] = _aligner_forward_ms(variables, data_dir)
    stats["card_vs_cpu"] = _aligner_card_vs_cpu(variables, data_dir)
    stats["thread_files"] = _realign_threads_alike(variables, data_dir, root)
    _hold_path_shapes(report, inputs, "prep_shapes", kernels=("attention",))
    stats["attention_times"] = aligner_attention_times(report)
    stats["phase_s"] = time.perf_counter() - t_phase
    report["prep"] = stats
    print(f"prep: seconds per step {stats['steps_s']} ({card})")


# ------------------------------------------------------------------ phase 5
def card_vs_cpu() -> None:
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model

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
    print(f"card vs CPU: {tf32_line()}")
    failed = []
    for i, name in enumerate(("audio", "video")):
        err = float(np.abs(out["cuda"][i] - out["cpu"][i]).max())
        print(f"card vs CPU, float32 {name} embedding: max|d|={err:.3g} "
              f"(tol {EMB_TOL})")
        if not err <= EMB_TOL:
            failed.append(f"{name} {err:.3g}")
    if failed:
        raise AssertionError(f"embeddings card vs CPU: {failed}")


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
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"card vs CPU, float32 train micro-step: loss {card_loss:.8f} vs "
          f"{cpu_loss:.8f} (relative {rel:.3g}, rtol 1e-4)")
    failed = []
    if not abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss):
        failed.append(f"loss card {card_loss} vs CPU {cpu_loss}")
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
            failed.append(f"gradient {name}: {used:.3g} of its tolerance")
    print(f"card vs CPU, float32 gradients ({len(cpu_g)} tensors), worst "
          "share of the tolerance used: audio (max|d| <= 1e-3 max|g| + 1e-8) "
          f"{worst['audio'][0]:.3g} at {worst['audio'][1]}, video (|d| <= "
          f"0.1 |g| + 1e-8) {worst['video'][0]:.3g} at {worst['video'][1]}")
    if failed:
        raise AssertionError(f"train micro-step card vs CPU: {failed}")


def run_card_vs_cpu() -> None:
    """Phase 5: both checks, each printed in full before either raises."""
    failed = []
    for check in (card_vs_cpu, card_vs_cpu_train):
        try:
            check()
        except AssertionError as e:
            print(f"card vs CPU: FAILED {e}")
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))


# ------------------------------------------------------------------ main
def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke run on one card")
    parser.add_argument("--phases", nargs="+", metavar="PHASE",
                        choices=("2", "3", "3q", "3x", "4a", "4b", "4e", "4p",
                                 "4r", "4s", "4c", "4d", "6", "7", "8", "5"),
                        help="run only these phases (default: all)")
    args = parser.parse_args()

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

    phases = (("2", lambda: (print_kernel_resources(),
                             check_attention(report),
                             check_attention_bwd(report),
                             check_loss(report))),
              ("3", lambda: run_slice(report, card)),
              ("3q", lambda: run_slice_int8(report, card, root)),
              ("3x", lambda: run_export(report, card, root)),
              ("4a", lambda: run_training(report, card, "deterministic")),
              ("4b", lambda: run_training(report, card, "default")),
              ("4e", lambda: run_training(report, card, "f32")),
              ("4p", lambda: run_data_parallel(report, card)),
              ("4r", lambda: run_remat(report, card)),
              ("4s", lambda: run_ablation_sweep(report, card, root)),
              ("4c", lambda: run_trainer(report, card)),
              ("4d", lambda: run_pipeline(report, card, root)),
              ("6", lambda: run_evaluation(report, card, root)),
              ("7", lambda: run_results(report, card, root)),
              ("8", lambda: run_prep(report, card, root)),
              ("5", run_card_vs_cpu))
    chosen = set(args.phases or [p for p, _ in phases])
    if "7" in chosen and "6" not in chosen:
        print("phase 7 reads phase 6's run directories and score files: "
              "phase 6 runs too")
        chosen.add("6")
    report: dict = {"launches": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")  # 4d's tree, for 6
    try:
        for phase, fn in phases:
            if phase not in chosen:
                continue
            t0 = time.perf_counter()
            fn()
            print(f"phase {phase} done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"chip_smoke: phases {sorted(chosen)} done in "
          f"{time.perf_counter() - T_START:.1f} s in all")
    if len(chosen) < len(phases):  # a part: its records, no summary
        print(json.dumps({k: v for k, v in report.items()
                          if k in ("launches", "evaluation", "results",
                                   "prep", "attention", "attention_bwd",
                                   "serve_int8", "export", "train_dp",
                                   "remat", "sweep", *TRAIN_TAGS.values())},
                         default=str))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
             for tag in TRAIN_TAGS.values()}
    print(json.dumps({"encode_pairs_per_s": report["encode_pairs_per_s"],
                      "batch": 32, "bucket_s": 2.3,
                      "audio_tower_ms_6s": report["audio_tower_ms_6s"],
                      "serve_int8": report["serve_int8"],
                      "export": report["export"],
                      **train,
                      "train_batch": TRAIN_B, "train_clip_s": TRAIN_SECONDS,
                      "train_dp": report["train_dp"],
                      "remat": report["remat"], "sweep": report["sweep"],
                      "trainer": report["trainer"],
                      "pipeline": report["pipeline"],
                      "evaluation": report["evaluation"],
                      "results": report["results"],
                      "prep": report["prep"],
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve_artifacts"]:  # phase 3x's second process
        sys.exit(serve_artifacts(sys.argv[2:]))
    if sys.argv[1:2] == ["--dp_rank"]:  # a rank of phase 4p (b)
        sys.exit(dp_rank(sys.argv[2:]))
    sys.exit(main())
