"""The yardstick's arithmetic: the card's peaks, a model's FLOPs, and the
bytes and operations of the attention forward.

Model FLOPs (2 per multiply-add) are counted by
`torch.utils.flop_counter.FlopCounterMode` on the plain reference
(`reference/model.py`) run on the meta device at one clip of a bucket's
shape: forward only, or forward and backward with no recompute.  B clips
cost B times one, so the count follows the shapes and not whatever
implements them.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Optional, Sequence

import torch

from benchmark import generate
from benchmark.reference import model as ref

PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
PEAK_F32_FLOPS = 67e12  # the same, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # the same, HBM3 bytes per second


def precision(hp: dict) -> str:
    """"bf16" or "fp32": the configuration's compute precision."""
    p = str(hp["training"]["trainer_args"]["precision"])
    return "bf16" if p in ("16", "bf16", "bfloat16") else "fp32"


def peak_flops(precision: str) -> float:
    return PEAK_BF16_FLOPS if precision == "bf16" else PEAK_F32_FLOPS


@functools.lru_cache(maxsize=None)
def _tower_flops(hp_json: str, seconds: float, train: bool
                 ) -> Dict[str, int]:
    from torch.utils.flop_counter import FlopCounterMode

    hp = json.loads(hp_json)
    w, h = hp["data"]["target_size"]
    frames, samples = generate.shape(hp, seconds)
    meta = {n: torch.empty(s, device="meta", requires_grad=train and not
                           n.endswith(("running_mean", "running_var")))
            for n, s, _ in ref.param_spec(hp)}
    video = torch.empty((1, frames, h, w, 3), dtype=torch.uint8,
                        device="meta")
    audio = torch.empty((1, samples), device="meta")
    lengths = torch.empty((1,), dtype=torch.int32, device="meta")
    out = {}
    for tower in ("video", "audio"):
        counter = FlopCounterMode(display=False)
        with torch.set_grad_enabled(train), counter:
            if tower == "video":
                y = ref.video_embed(meta, hp, video, lengths, train,
                                    ref.Ops())
            else:
                y = ref.audio_embed(meta, hp, audio, ref.Ops())
            if train:
                y.sum().backward()
        out[tower] = int(counter.get_total_flops())
    return out


def tower_flops(hp: dict, seconds: float, train: bool) -> Dict[str, int]:
    """{"video", "audio"}: the FLOPs of one clip of `seconds` through each
    tower, forward (`train` False) or forward and backward."""
    return _tower_flops(json.dumps(hp, sort_keys=True), float(seconds),
                        bool(train))


_DTYPE_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4,
                "torch.bfloat16": 2, "torch.float16": 2, "torch.float32": 4}


def attention_fwd(shape: Sequence[int], itemsize: int) -> Dict[str, float]:
    """Bytes and FLOPs the attention forward of q, k, v of `shape` (B, T,
    H, hd) needs: q, k and v read once and the output written once;
    Q K^T and P V at 2 T^2 hd a head and example each."""
    b, t, heads, hd = shape
    return {"bytes": 4.0 * b * t * heads * hd * itemsize,
            "flops": 4.0 * b * heads * t * t * hd}


def roofline_seconds(shape: Sequence[int], itemsize: int,
                     peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take for one attention forward."""
    work = attention_fwd(shape, itemsize)
    return max(work["bytes"] / PEAK_HBM_BYTES, work["flops"] / peak)


def itemsize_of(dtypes: Sequence[str], precision: str) -> int:
    """The bytes of q's element: from the profiler's recorded dtype where
    it has one, else from the configuration's precision."""
    if dtypes and dtypes[0] in _DTYPE_BYTES:
        return _DTYPE_BYTES[dtypes[0]]
    return 2 if precision == "bf16" else 4


def mfu(flops: float, seconds: float, precision: str) -> Optional[float]:
    """The share (%) of the card's dense peak that `flops` in `seconds`
    are."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / peak_flops(precision)


def attention_roofline(run, op: str = "peppa_tpu_torch::mha_attention"
                       ) -> Optional[float]:
    """The share (%) of the least time the card could take for every call
    of the attention forward op in a traced window, over the device time
    of the kernels the profiler attributes to those calls."""
    trace = run.get("trace")
    if not trace:
        return None
    bound = spent = 0.0
    prec = precision(run["hp"])
    for call in trace["calls"]:
        if call["name"] == op:
            size = itemsize_of(call["dtypes"], prec)
            bound += roofline_seconds(call["shapes"][0], size,
                                      peak_flops(prec))
            spent += call["device_s"]
    return 100.0 * bound / spent if spent > 0 else None
