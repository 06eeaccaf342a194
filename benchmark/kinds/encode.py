"""The `encode` driver: bulk scoring of a corpus, outside the service.

Each batch runs the model's eval forward (`PeppaPig` on a `ClipBatch` of
whole clips), `ops.loss.triplet_loss` and `ops.metrics.recall_at_n`; the
window dispatches `ahead` batches, then fetches one scalar of them.  Set-up
builds the model on the drawn weights, draws the base batch on the device
and runs one batch.  The check, after the window, takes batches drawn from
the seed among those the window finished, embeds them with the reference
in blocks of rows, and compares the embeddings, the loss, and each row's
recall against the reference's verdict on the program's own embeddings
(rows a rounding can decide are not judged).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import generate, kinds
from benchmark.program import build_model
from benchmark.reference import model as ref
from benchmark.trace import Window
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.ops.metrics import recall_at_n

CHECKED_BATCHES = 2
REFERENCE_ROWS = 32
RECALL_TOL = 1e-5  # cosines closer than this to clip j's leave row j open


def score(model, video, audio, margin: float, n: int):
    b, frames = video.shape[:2]
    dev = video.device
    batch = ClipBatch(
        video=video, audio=audio,
        video_duration=torch.full((b,), frames / generate.FPS, device=dev),
        audio_duration=torch.full((b,), frames / generate.FPS, device=dev),
        video_frames=torch.full((b,), frames, dtype=torch.int32, device=dev),
        audio_samples=torch.full((b,), audio.shape[1], dtype=torch.int32,
                                 device=dev))
    out = model(batch, train=False)
    loss = triplet_loss(out.video, out.audio, margin=margin)
    rec = recall_at_n(out.video, out.audio,
                      torch.eye(b, device=dev), n=n)
    return out.video, out.audio, loss, rec


def run(ctx: dict) -> dict:
    hp, traffic, seed, dev = ctx["hp"], ctx["traffic"], ctx["seed"], \
        ctx["device"]
    margin, n = float(hp["margin"]), int(traffic["recall_n"])
    weights = ref.draw_weights(hp, seed, dev)
    model = build_model(hp, weights, dev)
    ctx["marks"].append(("built", time.perf_counter()))
    del weights
    base_video, base_audio = generate.encode_base(traffic, hp, seed, dev)
    with torch.inference_mode():
        float(score(model, base_video, base_audio, margin, n)[2])
    win = Window(dev, ctx["seconds"], ctx["traced"])
    win.start()
    setup_s = win.t0 - ctx["t0"]
    outputs, batches, total = [], [], 0.0
    video = audio = v = a = loss = rec = acc = None
    with torch.inference_mode():
        while win.running():
            acc = torch.zeros((), device=dev)
            for _ in range(int(traffic["ahead"])):
                video, audio = generate.encode_batch(base_video, base_audio,
                                                     seed, len(outputs))
                with record_function("encode_score"):
                    v, a, loss, rec = score(model, video, audio, margin, n)
                outputs.append((v, a, loss, rec))
                batches.append({"traced": win.traced})
                acc = acc + v.sum() + a.sum() + loss + rec.sum()
            total += float(acc)
    win.stop()
    rows = int(traffic["batch"])
    for b in batches:
        b.update(pairs=rows, buckets=[(traffic["duration_s"],
                                       traffic["duration_s"])] * rows)
    record = {"setup_s": setup_s, "window_s": win.seconds,
              "memory_peak_bytes": kinds.peak_bytes(dev),
              "attempted": len(outputs),
              "failed": 0 if np.isfinite(total) else 1,
              "requests": batches}
    t = time.perf_counter()
    record["trace"] = win.reduce()
    record["trace_s"] = time.perf_counter() - t
    rng = np.random.default_rng([seed, 8])
    picked = sorted(rng.choice(len(outputs), min(CHECKED_BATCHES,
                                                 len(outputs)),
                               replace=False).tolist()) if outputs else []
    kept = {i: tuple(x.clone() for x in outputs[i]) for i in picked}
    del model, outputs, video, audio, v, a, loss, rec, acc
    kinds.release(dev)
    t_ref = time.perf_counter()

    w = ref.draw_weights(hp, seed, dev)
    ops = ref.Ops()
    emb_gap = loss_gap = cos_gap = 0.0
    sq, count = 0.0, 0
    recall_miss = 0 if kept else 1
    with torch.no_grad():
        for i, (v, a, loss, rec) in kept.items():
            video, audio = generate.encode_batch(base_video, base_audio,
                                                 seed, i)
            rv = ref.in_blocks(lambda lo, hi: ref.video_embed(
                w, hp, video[lo:hi], None, False, ops), rows, REFERENCE_ROWS)
            ra = ref.in_blocks(lambda lo, hi: ref.audio_embed(
                w, hp, audio[lo:hi], ops), rows, REFERENCE_ROWS)
            for x, rx in ((v, rv), (a, ra)):
                d = x.double() - rx.double()
                emb_gap = max(emb_gap, float(d.abs().max()))
                sq, count = sq + float((d * d).sum()), count + d.numel()
                cos_gap = max(cos_gap, float((1.0 - torch.nn.functional
                                              .cosine_similarity(
                                                  x.double(), rx.double(),
                                                  dim=1)).max()))
            rl = float(ref.contrastive_loss(rv.double(), ra.double(),
                                            margin))
            loss_gap = max(loss_gap, abs(float(loss) - rl) / abs(rl))
            verdict = ref.recall_verdicts(v, a, n, RECALL_TOL)
            judged = verdict >= 0
            recall_miss += int((rec[judged].round().long()
                                != verdict[judged]).sum())
    readings = {"emb_gap": emb_gap, "loss_gap": loss_gap,
                "emb_rms_gap": (sq / count) ** 0.5 if count else 0.0,
                "emb_cos_gap": cos_gap,
                "recall_miss": recall_miss}
    record["readings"] = readings
    record["reference_s"] = time.perf_counter() - t_ref
    record["checks"] = kinds.checks(readings, ctx["limits"])
    return record
