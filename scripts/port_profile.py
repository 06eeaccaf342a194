#!/usr/bin/env python3
"""Where the time goes in the port's encode path on one CUDA card.

    python3 scripts/port_profile.py

Builds the base configuration (`hparams_base.yaml`: wav2vec2-base +
R(2+1)D-18, bf16) from seeded random weights, then for one batch of 32
audio/video pairs of 2.3 s (the first serving bucket, full batch):
  - times each part with CUDA events (mean of 20 after 3 warm-up runs):
    the audio conv extractor, the transformer stack and head, the whole
    audio tower, the video trunk and the whole video tower;
  - traces one audio + video encode with `torch.profiler` and prints the
    device time by kernel name (top 20), the convolutions' device time by
    input shape (top 15), and the device kernel time against the traced
    window's host time.
Prints one JSON line of the part times last but one and the card's name
and power limit last.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import card_line, time_ms  # noqa: E402

BATCH, SECONDS = 32, 2.3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from peppa_tpu_torch.config import default_config
    from peppa_tpu_torch.models.dual_encoder import init_model

    cfg = default_config()
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

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            model.encode_audio(audio)
            model.encode_video(video)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel records only (the aten ops that launch them carry
    # the same time again); "Command Buffer Full" marks host stalls
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key != "Command Buffer Full"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"traced window {wall_ms:.2f} ms (host clock, profiler on); "
          f"device kernel time {busy_ms:.2f} ms")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for e in events[:20]:
        print(f"{e.device_time_total / 1e3:10.3f} {e.count:6d}  "
              f"{e.key[:110]}")
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::cudnn_convolution"]
    convs.sort(key=lambda e: e.device_time_total, reverse=True)
    print(f"{'device ms':>10} {'calls':>6}  convolution input shapes")
    for e in convs[:15]:
        print(f"{e.device_time_total / 1e3:10.3f} {e.count:6d}  "
              f"{str(e.input_shapes)[:110]}")
    card = card_line()
    for k, v in parts.items():
        print(f"{k}: {v:.3f} ms")
    print(json.dumps({"batch": b, "seconds": SECONDS, "parts_ms": parts,
                      "traced_wall_ms": wall_ms, "device_kernel_ms": busy_ms,
                      "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
