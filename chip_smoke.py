#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`peppa_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # one card, no arguments

Phases:
  1. the card's name and power limit; build the CUDA kernels from
     `peppa_tpu_torch/csrc/` (seconds printed);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with its time, the plain version's and a library
     yardstick's;
  3. the serving/eval forward of the base configuration (`hparams_base.yaml`:
     wav2vec2-base + R(2+1)D-18, bf16) at full width from seeded random
     weights: `EncoderService` warm-up and mixed-length requests over every
     bucket, then `eval_step` on a B=32 2.3 s batch; launch counts are
     reset just before and read just after;
  4. the same weights in float32 on the card (kernels) and on the CPU (plain
     versions) on one 2.3 s pair;
  5. one JSON line of per-kernel numbers, encode throughput, and the last
     line `{"ok": true, "device": {...}}`.

Any failed check raises, and the script exits non-zero.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): memory rate, dense bf16 tensor-core
# rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL_ATTN = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_pallas_kernels.py
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
EMB_TOL = 1e-4  # towers and embeddings, float32 (PARITY.md)


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
def check_attention(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from peppa_tpu_torch.ops.cuda.attention import (mha_attention,
                                                    mha_attention_plain)

    b, h, hd = 32, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
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
            if t == 316 and dtype == torch.bfloat16:
                report["attention"] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bms, "bound_by": by}
    report["attention"]["max_abs_err"] = worst


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


def run_slice(report: dict, card: str) -> None:
    import numpy as np
    import torch

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.cuda.attention import mha_attention
    from peppa_tpu_torch.ops.cuda.loss import fused_triplet_loss
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

    mha_attention.launches = 0
    fused_triplet_loss.launches = 0
    t0 = time.perf_counter()
    svc.warmup()
    a = svc.embed_audio(waves)
    v = svc.embed_video(clips)
    sim = svc.similarity(v, a)
    ev, ea, loss = eval_step(model, batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"attention": mha_attention.launches,
                "triplet_loss": fused_triplet_loss.launches}
    print(f"main path: warmup + {len(waves)} audio + {len(clips)} video "
          f"requests + eval step in {elapsed:.1f} s; launches {launches}; "
          f"{expected_audio} audio forwards")

    n_layers = model.audio_encoder.wav2vec2.cfg.num_layers
    if launches["attention"] != n_layers * expected_audio:
        raise AssertionError(f"attention launches {launches['attention']} "
                             f"!= {n_layers} x {expected_audio}")
    if launches["triplet_loss"] != 1:
        raise AssertionError(f"loss launches {launches['triplet_loss']} != 1")
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
    report["launches"] = launches

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
    del svc, model


# ------------------------------------------------------------------ phase 4
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
    for phase, fn in ((2, lambda: (check_attention(report),
                                   check_loss(report))),
                      (3, lambda: run_slice(report, card)),
                      (4, card_vs_cpu)):
        t0 = time.perf_counter()
        fn()
        print(f"phase {phase} done in {time.perf_counter() - t0:.1f} s")

    launches = report["launches"]
    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "peppa_tpu_torch/csrc/attention.cu",
         "replaces": "peppa_tpu/ops/pallas/attention.py:123",
         "launches": launches["attention"], **report["attention"]},
        {"name": "triplet_loss_fwd", "route": "cuda",
         "source": "peppa_tpu_torch/csrc/loss.cu",
         "replaces": "peppa_tpu/ops/pallas/loss.py:62",
         "launches": launches["triplet_loss"], **report["triplet_loss"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"encode_pairs_per_s": report["encode_pairs_per_s"],
                      "batch": 32, "bucket_s": 2.3, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
