"""Encode + score, train and host-fed throughput of the port on one card.

The counterpart of the JAX package's root `bench.py`:

    python -m peppa_tpu_torch.bench        # one JSON line on stdout

The line has the JAX script's keys:

- `value` (`metric` clip_pairs_per_sec_per_chip_encode_score): pairs/s of
  the full dual-encoder forward (wav2vec2-base + R(2+1)D-18 at 180x100,
  `video.midplanes_multiple` 128, bf16) plus `triplet_loss` and recall@10
  of each batch, at BENCH_BATCH pairs of 2.3 s clips.  The base batch is
  drawn once on the device.  Each of BENCH_K batches is a distinct variant
  of it (uint8 video XOR a random byte, audio times 1 +- 1e-3, drawn from
  a `torch.Generator` on the device), and the k batches run back to back
  with one synchronise and one scalar fetch at the end.  The time of a
  trivial synchronised call is subtracted; the result is the best of
  BENCH_REPEATS runs.
- `train_clips_per_sec`, `train_step_ms`, `train_recipe`: the production
  recipe (`hparams_tpu_production.yaml`: micro-batch 16 x accumulate 4,
  bf16, midplanes 128, the config's dropout 0.1 and loss) through
  `TrainState` and `train_step` on pre-staged distinct batches
  (BENCH_TRAIN=1).
- `host_fed`: pairs/s of a pack on disk -> `NativePack` ->
  `NativeBatchLoader` -> `Prefetcher` (side-stream copies) -> encode +
  score, a distribution over windows for each of BENCH_HOST_VARIANTS
  (f32, int16 audio in a v2 pack, a cold page cache first);
  `host_fed_pairs_per_sec` is the f32 median (BENCH_HOST_FED=1).
- `model_tflop_per_pair`: the forward of one pair of the configuration
  run, counted once per run by `torch.utils.flop_counter.FlopCounterMode`
  (2 per multiply-add), attention (a custom op the counter has no formula
  for) by formula, 4 T^2 hd a head and layer.
- `chip_peak_tflops_band`: [a bf16 8192^3 `torch.matmul` rate measured on
  the card in this run, 989]: 989 TFLOP/s is the H100 SXM data sheet's
  dense bf16 rate, against which `pct_of_chip_peak` reads value x
  model_tflop_per_pair (null for another configuration than
  `pct_assumes`).
- `vs_baseline`: null.  The JAX script divided `value` by BASELINE.json's
  5000 pairs/s, a target set for a TPU v4-8; the card has no such target.

Beyond them: `device` (the card's name and power limit from `nvidia-smi`)
and the peak memory (`torch.cuda.max_memory_allocated`, GiB) of the encode
and of the train recipe.  On the CPU (`device="cpu"`, for tests) the
card's numbers are null: no matmul rate, percentage, memory or name.

A failure raises and the CLI exits non-zero: no part is skipped or
replaced by null when it fails.

Knobs (environment, the JAX script's names and defaults): BENCH_BATCH=256,
BENCH_K=4, BENCH_REPEATS=3, BENCH_MIDPLANES=128 (0: the plain widths),
BENCH_INT8=0, BENCH_TRAIN=1, BENCH_HOST_FED=1,
BENCH_HOST_VARIANTS=f32,int16,cold, BENCH_HOST_BATCH=64,
BENCH_HOST_WINDOWS=3, BENCH_HOST_WINDOW_SECONDS=10, BENCH_HOST_ITEMS=192,
BENCH_INT16_AUDIO=0 (a v2 pack for every variant), BENCH_PACK (one pack
path for every variant; default: one per format in the temporary
directory, built once and reused).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from peppa_tpu_torch.config import Config, default_config
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.ops.metrics import recall_at_n
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.training.step import train_step
from peppa_tpu_torch.utils.device import resolve_device

CLIP_SECONDS = 2.3  # the first (busiest) serving bucket
FPS = 10.0
PACK_HW = (100, 180)  # a bench pack's frames: (height, width)
TRAIN_RECIPE = "16x4_bf16_midplanes128"  # hparams_tpu_production.yaml
PEAK_BF16_TFLOPS = 989.0  # H100 SXM data sheet, dense bf16
PEAK_MATMUL_N = 8192  # the measured matmul: (N x N) @ (N x N), bf16

Device = Optional[Union[str, torch.device]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(value: float, what: str) -> float:
    if not math.isfinite(value):
        raise FloatingPointError(f"{what}: {value}")
    return value


def clip_shape(cfg: Config) -> Tuple[int, int]:
    """(frames, samples) of a CLIP_SECONDS clip: 23 and 101,430 at 10 fps
    and 44.1 kHz."""
    return (int(round(CLIP_SECONDS * FPS)),
            int(round(CLIP_SECONDS * cfg.data.audio_sample_rate)))


def _full_batch(video: torch.Tensor, audio: torch.Tensor) -> ClipBatch:
    """A batch of whole CLIP_SECONDS clips: every frame and sample valid."""
    b, frames = video.shape[:2]
    dev = video.device
    return ClipBatch(
        video=video, audio=audio,
        video_duration=torch.full((b,), CLIP_SECONDS, device=dev),
        audio_duration=torch.full((b,), CLIP_SECONDS, device=dev),
        video_frames=torch.full((b,), frames, dtype=torch.int32, device=dev),
        audio_samples=torch.full((b,), audio.shape[1], dtype=torch.int32,
                                 device=dev))


def perturbed(base_video: torch.Tensor, base_audio: torch.Tensor,
              vbyte: torch.Tensor, ascale: torch.Tensor) -> ClipBatch:
    """A distinct variant of the base batch for about one pass over it:
    uint8 video XOR `vbyte` (stays uniform), audio times `ascale`."""
    return _full_batch(torch.bitwise_xor(base_video, vbyte),
                       base_audio * ascale)


def draw_perturbation(gen: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a uint8 byte, a scale in 1 +- 1e-3), 0-d tensors on `gen`'s
    device."""
    vbyte = torch.randint(0, 256, (), generator=gen, device=gen.device,
                          dtype=torch.uint8)
    ascale = 1.0 + (2.0 * torch.rand((), generator=gen, device=gen.device)
                    - 1.0) * 1e-3
    return vbyte, ascale


def encode_score_terms(model, batch: ClipBatch, margin: float):
    """(V, A, triplet_loss(V, A), recall@10 of each row) of one batch in
    eval mode: the body of the JAX script's `one_batch`.  Kernel 1 runs in
    the audio tower, kernel 3 in the loss."""
    out = model(batch, train=False)
    loss = triplet_loss(out.video, out.audio, margin=margin)
    eye = torch.eye(out.video.shape[0], device=out.video.device)
    rec = recall_at_n(out.video, out.audio, eye, n=10)
    return out.video, out.audio, loss, rec


def encode_score(model, batch: ClipBatch, margin: float) -> torch.Tensor:
    """sum(V) + sum(A) + loss + sum(recall@10): one float32 scalar that
    depends on every output, left on the device."""
    v, a, loss, rec = encode_score_terms(model, batch, margin)
    return (v.float().sum() + a.float().sum() + loss.float()
            + rec.float().sum())


# ------------------------------------------------------------- the encode
def _make_base(cfg: Config, b: int, frames: int, samples: int,
               device: torch.device):
    """The base batch, drawn once on the device from seed 0."""
    w, h = cfg.data.target_size
    gen = torch.Generator(device=device).manual_seed(0)
    video = torch.randint(0, 256, (b, frames, h, w, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    audio = torch.randn((b, samples), generator=gen, device=device) * 0.1
    return video, audio


def run_k(model, base_video: torch.Tensor, base_audio: torch.Tensor,
          seed: int, k: int, margin: float) -> float:
    """k distinct variants of the base batch encoded and scored back to
    back, their scalars summed on the device; one synchronise and one
    fetch at the end."""
    dev = base_video.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        acc = torch.zeros((), device=dev)
        for _ in range(k):
            batch = perturbed(base_video, base_audio,
                              *draw_perturbation(gen))
            acc = acc + encode_score(model, batch, margin)
        _sync(dev)
        return _finite(float(acc), "encode + score")


def _trivial(seed: int, device: torch.device) -> float:
    """The fixed cost of a synchronised call: the sum of 8x8 normals."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((8, 8), generator=gen, device=device).sum()
    _sync(device)
    return float(x)


def encode_pairs_per_sec(model, cfg: Config, batch_size: int, k: int,
                         repeats: int, frames: int, samples: int) -> float:
    """The JAX script's method: both programs run once uncounted, the
    least of max(repeats, 5) trivial synchronised calls is subtracted
    from each k-batch run, and the best of `repeats` runs counts."""
    dev = next(model.parameters()).device
    base_video, base_audio = _make_base(cfg, batch_size, frames, samples,
                                        dev)

    def timed(seed: int) -> float:
        t0 = time.perf_counter()
        run_k(model, base_video, base_audio, seed, k, cfg.margin)
        return time.perf_counter() - t0

    def timed_trivial(seed: int) -> float:
        t0 = time.perf_counter()
        _trivial(seed, dev)
        return time.perf_counter() - t0

    timed_trivial(0)
    timed(0)
    overhead = min(timed_trivial(1 + r) for r in range(max(repeats, 5)))
    per_batch = min(max(timed(1 + r) - overhead, 1e-9) / k
                    for r in range(repeats))
    return batch_size / per_batch


def _attention_flops(q_shape, k_shape, *args, out_shape=None, **kw) -> int:
    """Kernel 1's multiply-adds x 2: Q K^T and P V, 2 T_q T_k hd each per
    head and example."""
    b, tq, heads, hd = q_shape
    return 4 * b * heads * tq * k_shape[1] * hd


def model_flops_per_pair(model, cfg: Config, frames: int,
                         samples: int) -> int:
    """The FLOPs (2 per multiply-add) of one pair's forward through both
    towers on the model's device, by `FlopCounterMode`, the attention op
    by `_attention_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = next(model.parameters()).device
    w, h = cfg.data.target_size
    video = torch.zeros((1, frames, h, w, 3), dtype=torch.uint8, device=dev)
    audio = torch.zeros((1, samples), dtype=torch.float32, device=dev)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.peppa_tpu_torch.mha_attention: _attention_flops})
    with torch.inference_mode(), counter:
        model.encode_video(video)
        model.encode_audio(audio)
    return int(counter.get_total_flops())


def bf16_matmul_tflops(device: torch.device) -> float:
    """The rate of one bf16 PEAK_MATMUL_N^3 `torch.matmul` on the card
    (CUDA events over 20 calls after 3), TFLOP/s."""
    n = PEAK_MATMUL_N
    gen = torch.Generator(device=device).manual_seed(0)
    a, b = (torch.randn((n, n), generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    for _ in range(3):
        torch.matmul(a, b)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        torch.matmul(a, b)
    end.record()
    torch.cuda.synchronize(device)
    return 2.0 * n ** 3 / (start.elapsed_time(end) / 20 * 1e-3) / 1e12


def card_info(device: torch.device) -> Dict[str, Optional[object]]:
    """{"name", "power_limit_w"} of the card, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them
    (null on the CPU)."""
    if device.type != "cuda":
        return {"name": None, "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    name, limit = (s.strip() for s in out[index].rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0])}


def _peak_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


# ---------------------------------------------------------- the training
def train_throughput(frames: int, samples: int, micro_b: int = 16,
                     accum: int = 4, warmup_steps: int = 3,
                     timed_steps: int = 12,
                     device: Device = None) -> Dict[str, object]:
    """Micro-steps per second of the production recipe on `device` (None:
    the card; raises without CUDA): a fresh model and BertAdam at bf16,
    midplanes 128, the config's defaults otherwise (dropout 0.1, so the
    plain attention route) and `accum` micro-steps an optimizer step;
    `accum` distinct batches of `micro_b` clips staged on the device
    first; `warmup_steps` micro-steps, then `timed_steps` (whole
    accumulation cycles) timed to the fetch of the last loss."""
    if timed_steps % accum:
        raise ValueError(f"timed_steps {timed_steps} is not a whole number "
                         f"of accumulation cycles of {accum}")
    dev = resolve_device(device)
    cfg = default_config()
    cfg.training.precision = "bf16"
    cfg.video.midplanes_multiple = 128
    cfg.training.accumulate_grad_batches = accum
    model = init_model(cfg, seed=0, device=dev)
    state = TrainState.create(model, cfg)
    w, h = cfg.data.target_size
    batches = []
    for i in range(accum):
        gen = torch.Generator(device=dev).manual_seed(i)
        batches.append(_full_batch(
            torch.randint(0, 256, (micro_b, frames, h, w, 3), generator=gen,
                          device=dev, dtype=torch.uint8),
            torch.randn((micro_b, samples), generator=gen, device=dev)
            * 0.1))
    for i in range(warmup_steps):
        state, metrics = train_step(state, batches[i % accum], 7, device=dev)
        _finite(float(metrics["train_loss"]), "train loss")
    t0 = time.perf_counter()
    for i in range(timed_steps):
        state, metrics = train_step(state, batches[i % accum], 7, device=dev)
    loss = float(metrics["train_loss"])  # the fetch waits for the card
    elapsed = time.perf_counter() - t0
    _finite(loss, "train loss")
    return {
        "train_clips_per_sec": round(timed_steps * micro_b / elapsed, 1),
        "train_step_ms": round(1e3 * elapsed / timed_steps, 1),
        "train_recipe": TRAIN_RECIPE,
    }


# ------------------------------------------------------- the host-fed path
def _build_bench_pack(path: str, n_items: int, frames: int, samples: int,
                      audio_int16: bool = False) -> int:
    """Write a pack of `n_items` distinct synthetic 2.3 s clips drawn from
    `np.random.default_rng(42)`: the JAX script's bytes, a v1 pack
    (float32 audio) or, with `audio_int16`, a v2 pack."""
    from peppa_tpu_torch.data.cache import write_pack
    from peppa_tpu_torch.data.types import Clip

    rng = np.random.default_rng(42)

    def clips():
        for i in range(n_items):
            yield Clip(
                video=rng.integers(0, 256, (frames, *PACK_HW, 3), np.uint8),
                audio=(rng.standard_normal(samples) * 0.1).astype(np.float32),
                video_duration=2.3, audio_duration=2.3, index=i)

    return write_pack(path, clips(), audio_int16=audio_int16)


def _drop_file_cache(path: str) -> bool:
    """Evict `path` from the page cache: `fsync` (DONTNEED drops clean
    pages only, and a pack just written is dirty), then
    `posix_fadvise(DONTNEED)` on this one file.  Nothing system-wide.
    Returns True; a platform without the calls raises, so that a warm
    read is never reported as cold."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return True


def pack_path(frames: int, samples: int, audio_int16: bool) -> str:
    """The default pack of a format: BENCH_PACK, else a file of the
    temporary directory named by its shape and format."""
    return os.environ.get("BENCH_PACK", os.path.join(
        tempfile.gettempdir(), f"peppa_bench_pack_{frames}x{samples}"
        f"{'_i16' if audio_int16 else ''}.ppkc"))


def host_fed_pairs_per_sec(model, cfg: Config, frames: int, samples: int,
                           *, probe: bool = False, audio_int16: bool = False,
                           cold_cache: bool = False, device: Device = None):
    """Sustained pairs/s of pack -> native loader -> prefetch -> encode +
    score, on `device` (None: the card; raises without CUDA; the model
    must be there).

    Every batch has a distinct item composition (a fresh permutation per
    epoch) and each batch's scalar is fetched.  Returns a distribution,
    {"median", "min", "max", "windows", "window_seconds"}, over
    BENCH_HOST_WINDOWS disjoint windows of at least
    BENCH_HOST_WINDOW_SECONDS and 4 batches each.  `audio_int16` reads a
    v2 pack (int16 audio, scaled on the device); `cold_cache` evicts the
    pack from the page cache first and adds the first full pass over it,
    `first_pass_cold` (the windows after it are warm again).  `probe`
    times the loader alone, with no device in the loop, and returns its
    pairs/s."""
    from peppa_tpu_torch.native.loader import NativeBatchLoader, NativePack
    from peppa_tpu_torch.utils.prefetch import Prefetcher

    dev = resolve_device(device)
    b = int(os.environ.get("BENCH_HOST_BATCH", "64"))
    n_windows = int(os.environ.get("BENCH_HOST_WINDOWS", "3"))
    window_seconds = float(os.environ.get("BENCH_HOST_WINDOW_SECONDS", "10"))
    min_seconds = n_windows * window_seconds
    n_items = int(os.environ.get("BENCH_HOST_ITEMS", "192"))
    audio_i16 = audio_int16 or os.environ.get("BENCH_INT16_AUDIO", "0") == "1"
    path = pack_path(frames, samples, audio_i16)
    if not os.path.exists(path):
        _build_bench_pack(path, n_items, frames, samples,
                          audio_int16=audio_i16)
    cold_ok = cold_cache and _drop_file_cache(path)

    pack = NativePack(path)
    if audio_i16 != (np.dtype(pack.audio_dtype) == np.int16):
        # BENCH_PACK points every variant at one file: say so rather than
        # report a mislabeled number
        print(f"host-fed bench: pack {path} audio dtype is "
              f"{np.dtype(pack.audio_dtype).name}; variant labeled "
              f"{'int16' if audio_i16 else 'f32'} measures THIS pack")
    n_items = len(pack)
    pad = (frames, *PACK_HW, 3, samples)
    rng = np.random.default_rng(7)
    max_epochs = 400  # the plan's bound; the windows end on the clock
    plan = []
    for _ in range(max_epochs):
        order = rng.permutation(n_items)
        for lo in range(0, n_items - b + 1, b):
            plan.append((order[lo:lo + b].tolist(), pad))
    n_threads = min(os.cpu_count() or 4, 8)

    if probe:  # the host's assembly rate alone
        loader = NativeBatchLoader(pack, plan, n_threads=n_threads, depth=4)
        try:
            t0 = time.perf_counter()
            k = 0
            for _ in loader:
                k += 1
                if time.perf_counter() - t0 >= min_seconds and k >= 4:
                    break
            dt = time.perf_counter() - t0
        finally:
            loader.close()
            pack.close()
        item_bytes = (frames * PACK_HW[0] * PACK_HW[1] * 3
                      + samples * np.dtype(pack.audio_dtype).itemsize)
        print(f"native assembly only: {k * b / dt:.1f} pairs/s "
              f"({k * b * item_bytes / dt / 1e6:.0f} MB/s)")
        return k * b / dt

    def score(batch: ClipBatch) -> float:
        with torch.inference_mode():
            value = float(encode_score(model, batch, cfg.margin))
        return _finite(value, "host-fed encode + score")

    # the first forward (cuDNN's choices, the allocator) on a synthetic
    # batch of the loader's shapes, so that the pack stays untouched
    # until the timed loop (the cold variant needs it so)
    audio_dtype = torch.int16 if pack.audio_dtype == np.int16 \
        else torch.float32
    score(ClipBatch(
        video=torch.zeros((b, frames, *PACK_HW, 3), dtype=torch.uint8),
        audio=torch.zeros((b, samples), dtype=audio_dtype),
        video_duration=torch.full((b,), 2.3),
        audio_duration=torch.full((b,), 2.3),
        video_frames=torch.full((b,), frames, dtype=torch.int32),
        audio_samples=torch.full((b,), samples, dtype=torch.int32)).to(dev))
    if cold_ok:  # opening the pack read its header and index
        _drop_file_cache(path)
    loader = NativeBatchLoader(pack, plan, n_threads=n_threads, depth=4)
    prefetcher = Prefetcher(loader, dev, depth=2)
    batches_per_pass = max(n_items // b, 1)
    try:
        it = iter(prefetcher)
        first_pass = None
        if cold_ok:  # every payload byte of this pass comes from disk
            t0 = time.perf_counter()
            k = 0
            for batch in it:
                score(batch)
                k += 1
                if k >= batches_per_pass:
                    break
            first_pass = k * b / (time.perf_counter() - t0)
        windows = []
        for _ in range(n_windows):
            t0 = time.perf_counter()
            pairs = 0
            exhausted = False
            while True:
                batch = next(it, None)  # a finite plan ends the windows
                if batch is None:
                    exhausted = True
                    break
                score(batch)
                pairs += b
                if (time.perf_counter() - t0 >= window_seconds
                        and pairs >= 4 * b):
                    break
            if pairs >= 4 * b:  # only windows with enough signal
                windows.append(pairs / (time.perf_counter() - t0))
            if exhausted:
                print(f"host-fed bench: batch plan exhausted after "
                      f"{len(windows)} full windows (raise max_epochs or "
                      f"BENCH_HOST_ITEMS for more)")
                break
    finally:
        prefetcher.close()
        loader.close()
        pack.close()
    if not windows and first_pass is None:
        raise RuntimeError(f"host-fed bench: no window of {4 * b} pairs "
                           f"from {len(plan)} batches")
    if windows:
        ranked = sorted(windows)
        stats = {"median": round(ranked[len(ranked) // 2], 1),
                 "min": round(ranked[0], 1), "max": round(ranked[-1], 1),
                 "windows": [round(w, 1) for w in windows],
                 "window_seconds": window_seconds}
    else:  # the plan ran out before a window, after the cold first pass
        stats = {"median": None, "min": None, "max": None, "windows": [],
                 "window_seconds": window_seconds}
    if cold_cache:
        stats["first_pass_cold"] = (round(first_pass, 1)
                                    if first_pass is not None else None)
    return stats


# -------------------------------------------------------------------- main
def main(device: Device = None) -> Dict[str, object]:
    """Every part the knobs select, on `device` (None: the card; raises
    without CUDA); prints the JSON line and returns it as a dict."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    batch_size = int(os.environ.get("BENCH_BATCH", "256"))
    k_large = int(os.environ.get("BENCH_K", "4"))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    cfg = default_config()
    cfg.training.precision = "bf16"
    cfg.video.midplanes_multiple = int(
        os.environ.get("BENCH_MIDPLANES", "128")) or None
    cfg.tpu.quantize_int8 = os.environ.get("BENCH_INT8", "0") == "1"
    frames, samples = clip_shape(cfg)

    model = init_model(cfg, seed=0, device=dev)
    _reset_peak(dev)
    value = encode_pairs_per_sec(model, cfg, batch_size, k_large, repeats,
                                 frames, samples)
    encode_peak = _peak_gib(dev)
    flops = model_flops_per_pair(model, cfg, frames, samples)

    train = {"train_clips_per_sec": None, "train_step_ms": None,
             "train_recipe": None}
    train_peak = None
    if os.environ.get("BENCH_TRAIN", "1") == "1":
        _reset_peak(dev)
        train = train_throughput(frames, samples, device=dev)
        train_peak = _peak_gib(dev)

    host_fed = {}
    if os.environ.get("BENCH_HOST_FED", "1") == "1":
        for variant in os.environ.get("BENCH_HOST_VARIANTS",
                                      "f32,int16,cold").split(","):
            variant = variant.strip()
            if variant:
                host_fed[variant] = host_fed_pairs_per_sec(
                    model, cfg, frames, samples,
                    audio_int16=variant == "int16",
                    cold_cache=variant == "cold", device=dev)

    matmul_tflops = bf16_matmul_tflops(dev) if on_card else None
    tflop_per_pair = flops / 1e12
    default_model = (cfg.video.midplanes_multiple == 128
                     and not cfg.tpu.quantize_int8)
    pct = (100.0 * value * tflop_per_pair / PEAK_BF16_TFLOPS
           if on_card and default_model else None)
    f32 = host_fed.get("f32")
    line = {
        "metric": "clip_pairs_per_sec_per_chip_encode_score",
        "value": round(value, 1),
        "unit": "pairs/s/chip",
        "vs_baseline": None,
        "pct_of_chip_peak": None if pct is None else round(pct, 2),
        "pct_assumes": {"midplanes_multiple": 128, "int8": False},
        "chip_peak_tflops_band": [
            None if matmul_tflops is None else round(matmul_tflops, 1),
            PEAK_BF16_TFLOPS],
        "model_tflop_per_pair": round(tflop_per_pair, 6),
        "host_fed_pairs_per_sec": f32 and f32.get("median"),
        "host_fed": host_fed,
        **train,
        "device": card_info(dev),
        "encode_peak_memory_gib": encode_peak,
        "train_peak_memory_gib": train_peak,
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
