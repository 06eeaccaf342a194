#!/usr/bin/env python3
"""Where the time goes in the port's encode path and train micro-step on
one CUDA card.

    python3 scripts/port_profile.py

Builds the base configuration (`hparams_base.yaml`: wav2vec2-base +
R(2+1)D-18, bf16) from seeded random weights, then
  encode: for one batch of 32 audio/video pairs of 2.3 s (the first serving
    bucket, full batch), times each part with CUDA events (mean of 20 after
    3 warm-up runs): the audio conv extractor, the transformer stack and
    head, the whole audio tower, the video trunk and the whole video tower;
  train: for one micro-batch of 8 pairs of 2.3 s (`hparams_base.yaml`'s
    batch), in the default configuration (dropout 0.1, layer-drop 0.05:
    attention on the plain route) and with `audio.dropout: 0.0` (attention
    through the forward and backward kernels), times the audio tower's
    forward + backward, the video tower's forward + backward, the loss's
    forward + backward, the gradient-accumulation update, the BertAdam step
    and the whole `train_step` (mean of 5 after 2 warm-up runs);
and traces each with `torch.profiler`: the device time by kernel name (top
20), the convolutions' device time by input shape (top 15, encode), and the
device kernel time against the traced window's host time.  Prints one JSON
line of the part times last but one and the card's name and power limit
last.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import card_line, time_ms  # noqa: E402

BATCH, SECONDS = 32, 2.3
TRAIN_BATCH = 8


def _trace(fn):
    """(host ms of the traced window, device kernel ms, profile) of one
    synchronised call of `fn` under `torch.profiler`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel records only (the aten ops that launch them carry
    # the same time again); "Command Buffer Full" marks host stalls, and
    # user annotations (the optimizer's `step`) span other kernels
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key != "Command Buffer Full"
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"traced window {wall_ms:.2f} ms (host clock, profiler on); "
          f"device kernel time {busy_ms:.2f} ms")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for e in events[:20]:
        print(f"{e.device_time_total / 1e3:10.3f} {e.count:6d}  "
              f"{e.key[:110]}")
    return wall_ms, busy_ms, prof


def profile_train(cfg, deterministic: bool) -> dict:
    """Part times of one train micro-step (module doc)."""
    import numpy as np
    import torch

    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.ops.loss import triplet_loss
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    cfg = copy.deepcopy(cfg)
    if deterministic:
        cfg.audio.dropout = 0.0
    model = init_model(cfg, seed=0)
    state = TrainState.create(model, cfg)
    w, h = cfg.data.target_size
    b = TRAIN_BATCH
    samples = int(round(SECONDS * cfg.data.audio_sample_rate))
    frames = int(round(SECONDS * 10))
    gen = torch.Generator(device="cuda").manual_seed(0)
    audio = 0.1 * torch.randn(b, samples, generator=gen, device="cuda")
    video = torch.randint(0, 256, (b, frames, h, w, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    batch = ClipBatch(video=video, audio=audio,
                      video_duration=torch.full((b,), SECONDS),
                      audio_duration=torch.full((b,), SECONDS),
                      video_frames=torch.full((b,), frames),
                      audio_samples=torch.full((b,), samples))
    dv = torch.randn(b, 512, generator=gen, device="cuda")

    def tower(encode, x, **kw):
        def run():
            model.zero_grad(set_to_none=True)
            torch.sum(encode(x, train=True, **kw) * dv).backward()
        return run

    def loss_fwd_bwd():
        v = dv.clone().requires_grad_()
        a = torch.roll(dv, 1, 0).requires_grad_()
        triplet_loss(v, a, cfg.margin).backward()

    def full_step():
        train_step(state, batch, seed=0)

    parts = {}
    parts["audio_fwd_bwd"] = time_ms(
        tower(model.encode_audio, audio, generator=gen), iters=5, warmup=2)
    parts["video_fwd_bwd"] = time_ms(tower(model.encode_video, video),
                                     iters=5, warmup=2)
    parts["loss_fwd_bwd"] = time_ms(loss_fwd_bwd, iters=5, warmup=2)
    # the model's .grad is set by the last tower run; one Welford fold of
    # every trained tensor, then one BertAdam step over them
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in state.params.items()}
    acc = {n: torch.zeros_like(g, dtype=torch.float32)
           for n, g in grads.items()}

    def accumulate():
        for n, g in grads.items():
            acc[n].add_((g.float() - acc[n]) / 2)

    def optimizer_step():
        for n, p in state.params.items():
            p.grad = grads[n]
        state.optimizer.step()

    parts["grad_accumulate"] = time_ms(accumulate, iters=5, warmup=2)
    parts["optimizer_step"] = time_ms(optimizer_step, iters=5, warmup=2)
    # 7 micro-steps of 8: the accumulation, not the optimizer step
    parts["train_step"] = time_ms(full_step, iters=5, warmup=2)
    tag = "deterministic" if deterministic else "default"
    print(f"--- train micro-step ({tag}): torch.profiler over one train_step")
    wall_ms, busy_ms, _ = _trace(full_step)
    parts["traced_wall_ms"] = wall_ms
    parts["device_kernel_ms"] = busy_ms
    del state, model
    return parts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: CUDA is not available", file=sys.stderr)
        return 2

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model

    cfg = default_config()
    report = {}
    for deterministic in (False, True):
        tag = "deterministic" if deterministic else "default"
        report[f"train_{tag}_ms"] = profile_train(cfg, deterministic)
    model = init_model(cfg, seed=0)
    w, h = cfg.data.target_size
    b = BATCH
    samples = int(round(SECONDS * cfg.data.audio_sample_rate))
    frames = int(round(SECONDS * 10))
    gen = torch.Generator(device="cuda").manual_seed(0)
    audio = 0.1 * torch.randn(b, samples, generator=gen, device="cuda")
    video = torch.randint(0, 256, (b, frames, h, w, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    w2v = model.audio_encoder.wav2vec2
    venc = model.video_encoder

    parts = {}
    with torch.inference_mode():
        parts["audio_conv_extractor"] = time_ms(
            lambda: w2v.feature_extractor(audio))
        # the trunk to its logits, less the extractor: transformer + head
        parts["audio_after_conv"] = time_ms(
            lambda: w2v(audio, tap="logits")) - parts["audio_conv_extractor"]
        parts["audio_tower"] = time_ms(lambda: model.encode_audio(audio))
        vin = (video.float() / 255.0).to(venc.dtype).permute(0, 4, 1, 2, 3)
        parts["video_trunk"] = time_ms(lambda: venc.trunk(vin))
        parts["video_tower"] = time_ms(lambda: model.encode_video(video))

    print("--- encode: torch.profiler over one audio + video encode")
    with torch.inference_mode():
        wall_ms, busy_ms, prof = _trace(lambda: (model.encode_audio(audio),
                                                 model.encode_video(video)))
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::cudnn_convolution"]
    convs.sort(key=lambda e: e.device_time_total, reverse=True)
    print(f"{'device ms':>10} {'calls':>6}  convolution input shapes")
    for e in convs[:15]:
        print(f"{e.device_time_total / 1e3:10.3f} {e.count:6d}  "
              f"{str(e.input_shapes)[:110]}")
    report.update({"batch": b, "seconds": SECONDS, "parts_ms": parts,
                   "traced_wall_ms": wall_ms, "device_kernel_ms": busy_ms})
    card = card_line()
    for k, v in report.items():
        print(f"{k}: {v}")
    print(json.dumps({**report, "train_batch": TRAIN_BATCH, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
