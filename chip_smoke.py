#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`peppa_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # one card, no arguments

Phases:
  1. the card's name and power limit; build the CUDA kernels from
     `peppa_tpu_torch/csrc/` (seconds printed);
  2. the bf16 attention forward's registers and spill bytes (`ptxas -v`);
     each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, with its time, the plain version's and a library
     yardstick's: the attention forward (serving shapes, T=316 and 826),
     the attention backward (training shapes), the triplet-loss forward
     and, beside it, the loss's closed-form backward;
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
     the same seed to show the run is reproducible;
  5. the same weights in float32 on the card (kernels) and on the CPU (plain
     versions): the serving embeddings of one 2.3 s pair, and one training
     micro-step (2 layers, B=2, `audio.dropout: 0.0`): loss and gradients;
  6. one JSON line of per-kernel numbers, the serving and training metrics,
     and the last line `{"ok": true, "device": {...}}`.

Launch counts are set to 0 just before each main path (3, 4a, 4b) and read
just after it.

Any failed check raises, and the script exits non-zero.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

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


def bound(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2
def print_forward_resources() -> None:
    """Registers and spill bytes of each bf16 attention forward
    instantiation (head dim, vector path), from `ptxas -v` in this
    process's build."""
    from peppa_tpu_torch.ops.cuda import build

    log = build.build_log.get("attention")
    if log is None:
        print("attention_fwd_bf16_kernel: built by an earlier process, no "
              "ptxas report here")
        return
    name, spills = None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        tag = re.search(r"attention_fwd_bf16_kernelILi(\d+)ELb([01])E",
                        name or "")
        if m and tag:
            print(f"attention_fwd_bf16_kernel<hd {tag.group(1)}, vec "
                  f"{tag.group(2)}>: {m.group(1)} registers, spill stores "
                  f"{spills[0]} bytes, spill loads {spills[1]} bytes")


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
                _, lse = _launch(q, k, v, lengths, scale, with_lse=True)
                got = mha_attention_bwd(q, k, v, do, lengths, scale, lse)
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
            # times at the training path's call: no lengths
            _, lse = _launch(q, k, v, None, scale, with_lse=True)
            ms = time_ms(lambda: mha_attention_bwd(q, k, v, do, None, scale,
                                                   lse))
            plain_ms = time_ms(lambda: mha_attention_bwd_plain(
                q, k, v, do, None, scale), iters=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
            elem = q.element_size()
            n_bytes = 7 * b * t * h * hd * elem  # q, k, v, dO in; dQ, dK, dV
            flops = 10 * b * h * t * t * hd  # five products of T^2 hd
            bms, by = bound(n_bytes, flops, name)
            print(f"attention bwd T={t} {name}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})")
            if dtype == torch.bfloat16:
                rows.append({"T": t, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": bms,
                             "bound_by": by})
            del out
    report["attention_bwd"] = {
        **{k: v for k, v in rows[0].items() if k != "T"},
        "max_abs_err": worst, "shapes": rows}


def check_loss(report: dict) -> None:
    import torch

    from peppa_tpu_torch.ops.cuda.loss import (fused_triplet_loss,
                                               fused_triplet_loss_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for b in (8, 13, 32, 1024):
        d = 512
        v = torch.randn(b, d, generator=gen, device="cuda")
        a = torch.randn(b, d, generator=gen, device="cuda")
        got = fused_triplet_loss(v, a, 0.2)
        want = fused_triplet_loss_plain(v, a, 0.2)
        torch.cuda.synchronize()
        err = abs(got.item() - want.item())
        print(f"loss B={b}: kernel {got.item():.8f} plain {want.item():.8f} "
              f"max|d|={err:.3g}")
        if not err <= LOSS_ATOL + LOSS_RTOL * abs(want.item()):
            raise AssertionError(f"loss B={b}: {got.item()} vs {want.item()}")
        if b == 32:
            worst = err
            ms = time_ms(lambda: fused_triplet_loss(v, a, 0.2))
            plain_ms = time_ms(lambda: fused_triplet_loss_plain(v, a, 0.2))
            bms, by = bound(2 * b * d * 4 + 4, 2 * b * b * d, "float32")
            print(f"loss B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bms:.6f} ms ({by})")
            report["triplet_loss"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bms, "bound_by": by}
    report["triplet_loss"]["max_abs_err"] = worst

    # the loss's closed-form backward (plain PyTorch, as the JAX package's
    # XLA) behind the kernel, against autograd of the plain forward
    v = torch.randn(TRAIN_B, 512, generator=gen, device="cuda",
                    requires_grad=True)
    a = torch.randn(TRAIN_B, 512, generator=gen, device="cuda",
                    requires_grad=True)
    got = torch.autograd.grad(fused_triplet_loss(v, a, 0.2), (v, a))
    want = torch.autograd.grad(fused_triplet_loss_plain(v, a, 0.2), (v, a))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"loss backward B={TRAIN_B}: max|d|={err:.3g} against autograd of "
          "the plain forward")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


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
            "triplet_loss_fwd": fused_triplet_loss.launches}


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
            "triplet_loss_fwd": 1}
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
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        state, m = train_step(state, batch, seed=0)
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
          f"{TRAIN_SECONDS} s), {TRAIN_B / ms * 1e3:.2f} train clips/s "
          f"({card})")
    n_layers = model.audio_encoder.wav2vec2.cfg.num_layers
    n_attn = n_layers * TRAIN_MICRO_STEPS if deterministic else 0
    want = {"attention_fwd": n_attn, "attention_bwd": n_attn,
            "triplet_loss_fwd": TRAIN_MICRO_STEPS}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if first_moved.item() != 0.0 or not moved > 0.0 or not stats_moved > 0:
        raise AssertionError(f"{tag}: parameters/statistics did not move "
                             "as the schedule says")
    report["launches"][tag] = launches
    report[tag] = {"ms_per_micro_step": ms,
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

    report: dict = {}
    for phase, fn in ((2, lambda: (print_forward_resources(),
                                   check_attention(report),
                                   check_attention_bwd(report),
                                   check_loss(report))),
                      (3, lambda: run_slice(report, card)),
                      ("4a", lambda: run_training(report, card, True)),
                      ("4b", lambda: run_training(report, card, False)),
                      (5, lambda: (card_vs_cpu(), card_vs_cpu_train()))):
        t0 = time.perf_counter()
        fn()
        print(f"phase {phase} done in {time.perf_counter() - t0:.1f} s")

    paths = report["launches"]  # path -> kernel -> launches
    kernels = []
    for name, replaces, source_report in (
            ("attention_fwd", "peppa_tpu/ops/pallas/attention.py:123",
             "attention"),
            ("attention_bwd", "peppa_tpu/ops/pallas/attention.py:137",
             "attention_bwd"),
            ("triplet_loss_fwd", "peppa_tpu/ops/pallas/loss.py:62",
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
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
