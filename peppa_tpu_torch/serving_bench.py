"""Serving and export benchmark of the port on one card.

The counterpart of the JAX package's `scripts/serving_bench.py`:

    python -m peppa_tpu_torch.serving_bench [--requests 4] [--batch 8]

prints one JSON object, on the base configuration in bf16 with
`video.midplanes_multiple` 128 (wav2vec2-base + R(2+1)D-18, seeded
weights):

1. `warmup_s`: the wall time of `EncoderService(model, cfg,
   batch_size=--batch).warmup()`, every (bucket, batch) shape run once
   (the kernels' first calls, cuDNN's choices); `n_programs`, 2 per
   bucket; `batch`.
2. `dispatch_overhead_ms`: the least of 5 trivial synchronised calls on
   the device, for reading the latencies.
3. `latency`: one row per bucket: the wall time of `embed_audio` and
   `embed_video` for a full batch of distinct pre-generated requests (host
   padding and the copies in and out included), p50 and max over
   --requests batches; `audio_mb` and `video_mb`, one batch's payload.
4. `export_roundtrip`: a small artifact (batch 2, the first bucket)
   written by `export_encoders` for the card and the CPU (`torch.export`
   programs, not StableHLO), served by `ExportedEncoders` on the card in
   this process and on the CPU in a child process that imports
   `peppa_tpu_torch` alone, with JAX blocked.  `agree` compares each pair
   of embeddings (max abs difference, least row cosine):
   `exported_cuda_vs_live` (the card's artifact against the live model
   through an `EncoderService` of the artifact's batch size) and
   `exported_cpu_vs_exported_cuda`.  The programs hold the op
   `peppa_tpu_torch::mha_attention`, so the card's artifact runs kernel 1
   and the CPU's its plain version.  With the export's, the card load's
   and the child's seconds.  On the CPU (`device="cpu"`) both artifacts
   are the CPU's: `exported_cpu_vs_live`, `exported_cpu_vs_exported_cpu`.

`start` runs parts 1-4 up to the child, which then works on the CPU while
the caller goes on; `finish` waits for it.  A failure raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from peppa_tpu_torch.bench import Device, card_info
from peppa_tpu_torch.config import default_config
from peppa_tpu_torch.export import ExportedEncoders, export_encoders
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.utils.device import resolve_device

EXPORT_BATCH = 2  # the round trip's artifact: batch 2, the first bucket
CHILD_TIMEOUT_S = 1200  # the CPU child: full-width bf16 towers on the host
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CPU_CHILD = r"""
import os, sys, time
t0 = time.perf_counter()
os.nice(10)  # the host's cores go first to the caller's work meanwhile
for blocked in ("jax", "flax", "msgpack"):
    sys.modules[blocked] = None  # any import of these now fails
sys.path.insert(0, sys.argv[1])
import numpy as np
from peppa_tpu_torch.export import ExportedEncoders

art, io_npz, out_npz = sys.argv[2:5]
with np.load(io_npz) as z:
    items = {kind: [z[k] for k in sorted(z.files) if k.startswith(kind)]
             for kind in ("audio", "video")}
exp = ExportedEncoders(art, device="cpu")
np.savez(out_npz, audio=exp.embed_audio(items["audio"]),
         video=exp.embed_video(items["video"]))
leaked = sorted(m for m in sys.modules
                if m == "peppa_tpu" or m.startswith("peppa_tpu."))
assert not leaked, leaked
print(f"cpu child ok in {time.perf_counter() - t0:.1f} s")
"""


def _t(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _p(xs: List[float], q: float) -> float:
    return round(float(np.percentile(np.asarray(xs) * 1000, q)), 1)


def agree(x, y) -> Dict[str, float]:
    """Max abs difference and least row cosine of two (N, D) arrays, in
    float64."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    cos = np.sum(x * y, 1) / np.maximum(
        np.linalg.norm(x, axis=1) * np.linalg.norm(y, axis=1), 1e-12)
    return {"max_abs": float(np.max(np.abs(x - y))),
            "min_cos": float(np.min(cos))}


class Pending:
    """The export round trip's CPU child, started by `start`: `finish`
    waits for it and returns the whole record; `close` stops it if it
    still runs and removes the work directory."""

    def __init__(self, record: Dict, plat: str, work: str,
                 proc: subprocess.Popen, exported: Dict, out_npz: str):
        self.record = record
        self._plat = plat
        self._work = work
        self._proc = proc
        self._exported = exported
        self._out_npz = out_npz

    def finish(self) -> Dict:
        out, err = self._proc.communicate(timeout=CHILD_TIMEOUT_S)
        if self._proc.returncode != 0:
            raise RuntimeError(f"the CPU child exited "
                               f"{self._proc.returncode}:\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
        trip = self.record["export_roundtrip"]
        trip["cpu_child_s"] = float(out.split()[-2])  # its own clock
        with np.load(self._out_npz) as cpu:
            trip[f"exported_cpu_vs_exported_{self._plat}"] = {
                "audio": agree(cpu["audio"], self._exported["audio"]),
                "video": agree(cpu["video"], self._exported["video"])}
        return self.record

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        shutil.rmtree(self._work, ignore_errors=True)


def start(requests: int = 4, batch: int = 8, device: Device = None
          ) -> Pending:
    """Parts 1-4 of the module doc on `device` (None: the card; raises
    without CUDA), up to the CPU child, which is left running."""
    dev = resolve_device(device)
    cfg = default_config()
    cfg.training.precision = "bf16"
    cfg.video.midplanes_multiple = 128
    model = init_model(cfg, seed=0, device=dev)
    svc = EncoderService(model, cfg, batch_size=batch, device=dev)

    def trivial(seed: int) -> float:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return float(torch.randn((8, 8), generator=gen, device=dev).sum())

    trivial(0)
    overhead = min(_t(lambda s=s: trivial(s)) for s in range(1, 6))

    # ---- 1. warm-up
    t0 = time.perf_counter()
    svc.warmup()
    warmup_s = time.perf_counter() - t0

    # ---- 2. latency per bucket, on distinct pre-generated payloads
    rng = np.random.default_rng(0)
    w, h = cfg.data.target_size
    rows = []
    for b in svc.buckets:
        s = int(round(b * svc.sample_rate))
        t = int(round(b * svc.fps))
        audio_reqs = [[rng.standard_normal(s).astype(np.float32) * 0.1
                       for _ in range(batch)] for _ in range(requests)]
        video_reqs = [[rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
                       for _ in range(batch)] for _ in range(requests)]
        a_lat = [_t(lambda r=r: svc.embed_audio(r)) for r in audio_reqs]
        v_lat = [_t(lambda r=r: svc.embed_video(r)) for r in video_reqs]
        rows.append({
            "bucket_s": b,
            "audio_ms": {"p50": _p(a_lat, 50), "max": _p(a_lat, 100)},
            "video_ms": {"p50": _p(v_lat, 50), "max": _p(v_lat, 100)},
            "audio_mb": round(batch * s * 4 / 1e6, 1),
            "video_mb": round(batch * t * h * w * 3 / 1e6, 1)})
        print("bucket", rows[-1], flush=True)

    # ---- 3. the export round trip on a small artifact
    bucket = svc.buckets[0]
    s0 = int(round(bucket * svc.sample_rate))
    t0f = int(round(bucket * svc.fps))
    items = {"audio": [rng.standard_normal(s0).astype(np.float32) * 0.1
                       for _ in range(EXPORT_BATCH)],
             "video": [rng.integers(0, 256, (t0f, h, w, 3)).astype(np.uint8)
                       for _ in range(EXPORT_BATCH)]}
    live_svc = EncoderService(model, cfg, batch_size=EXPORT_BATCH,
                              buckets=(bucket,), device=dev)
    live = {"audio": live_svc.embed_audio(items["audio"]),
            "video": live_svc.embed_video(items["video"])}

    plat = dev.type
    work = tempfile.mkdtemp(prefix="serving_bench_")
    try:
        art = os.path.join(work, "export")
        t0 = time.perf_counter()
        export_encoders(model, cfg, art, batch_size=EXPORT_BATCH,
                        buckets=(bucket,),
                        platforms=(plat, "cpu") if plat != "cpu"
                        else ("cpu",))
        export_s = time.perf_counter() - t0
        io_npz = os.path.join(work, "io.npz")
        np.savez(io_npz, **{f"{kind}_{i:03d}": x
                            for kind, xs in items.items()
                            for i, x in enumerate(xs)})
        out_npz = os.path.join(work, "cpu.npz")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.Popen(
            [sys.executable, "-c", _CPU_CHILD, REPO, art, io_npz, out_npz],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    try:
        t0 = time.perf_counter()
        exp = ExportedEncoders(art, device=dev)
        load_s = time.perf_counter() - t0
        exported = {"audio": exp.embed_audio(items["audio"]),
                    "video": exp.embed_video(items["video"])}
        del exp
    except BaseException:
        proc.kill()
        proc.wait()
        shutil.rmtree(work, ignore_errors=True)
        raise
    record = {
        "warmup_s": round(warmup_s, 1),
        "n_programs": 2 * len(svc.buckets),
        "batch": batch,
        "dispatch_overhead_ms": round(overhead * 1000, 1),
        "latency": rows,
        "export_roundtrip": {
            f"exported_{plat}_vs_live": {
                kind: agree(exported[kind], live[kind])
                for kind in ("audio", "video")},
            "batch": EXPORT_BATCH, "bucket_s": bucket,
            "platforms": [plat, "cpu"] if plat != "cpu" else ["cpu"],
            "export_s": round(export_s, 1), "load_s": round(load_s, 1)},
        "device": card_info(dev),
    }
    return Pending(record, plat, work, proc, exported, out_npz)


def main(argv: Optional[Sequence[str]] = None,
         device: Device = None) -> Dict:
    """The CLI: the whole record, printed as one JSON object and
    returned."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    pending = start(args.requests, args.batch, device)
    try:
        record = pending.finish()
    finally:
        pending.close()
    print(json.dumps(record, indent=2))
    return record


if __name__ == "__main__":
    main()
