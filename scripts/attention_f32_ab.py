#!/usr/bin/env python3
"""Time the float32 routes of kernels 1 and 2 of one checkout's port on
one CUDA card.

    python3 scripts/attention_f32_ab.py [TREE] [--only fwd|bwd] [--profile]

TREE is the root of a checkout (default: this one) whose `peppa_tpu_torch`
is timed with this checkout's `chip_smoke.f32_attention_times` and
`chip_smoke.attention_bwd_times`, so that two trees (a parent and a
change, run in turns in one call) are measured alike.  Builds TREE's
kernels, then times in float32 at the main paths' shapes, back-to-back and
replayed from a CUDA graph, beside SDPA's call on the same inputs, and
holds each against the plain version: `mha_attention` (kernel 1; B=32,
T=316, no lengths: the float32 `grsa.Embedder`; B=1, T = 99, 199, 399,
799, key length T - 1: the aligner) and `mha_attention_bwd` (kernel 2,
fed by kernel 1's output and log-sum-exp; B=8, T=316 and 826: float32
training's micro-batch; B=2, T=316: the card-vs-CPU micro-step).  `--only`
times one direction; `--profile` adds each backward kernel's (dq, dkdv)
mean device time over 20 calls at those shapes from `torch.profiler`.
Prints one JSON line, then the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD_SHAPES = ((8, 316), (8, 826), (2, 316))


def bwd_times(b: int, t: int) -> dict:
    """Kernel 2 in float32 at (b, t, 12, 64) on seeded inputs, held against
    its plain version, then timed (`chip_smoke.attention_bwd_times`)."""
    import torch

    from chip_smoke import _check_bwd, attention_bwd_times

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(b, t, 12, 64, generator=gen, device="cuda")
                   for _ in range(4))
    err = _check_bwd(q, k, v, do, None, f"B={b} T={t} float32 full")
    return attention_bwd_times(q, k, v, do, err)


def bwd_kernel_ms(b: int, t: int) -> dict:
    """Mean device ms of each float32 backward kernel over 20 calls at (b,
    t, 12, 64), by `torch.profiler`'s kernel names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peppa_tpu_torch.ops.cuda.attention import _launch, mha_attention_bwd

    scale = 64 ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, t, 12, 64, generator=gen, device="cuda")
                   for _ in range(4))
    out, lse = _launch(q, k, v, None, scale, with_lse=True)
    for _ in range(5):
        mha_attention_bwd(q, k, v, do, None, scale, lse, out)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            mha_attention_bwd(q, k, v, do, None, scale, lse, out)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        for name in ("dq", "dkdv"):
            if f"attention_bwd_{name}_f32" in e.key:
                ms[name] = e.device_time_total / e.count / 1e3
    print(f"attention bwd float32 B={b} T={t} kernels (torch.profiler): "
          + ", ".join(f"{n} {x:.4f} ms" for n, x in ms.items()))
    return {"B": b, "T": t, **{f"{n}_ms": x for n, x in ms.items()}}


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="time the float32 attention kernels of one checkout")
    parser.add_argument("tree", nargs="?", default=ROOT)
    parser.add_argument("--only", choices=("fwd", "bwd"))
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    from chip_smoke import ALIGN_T, card_line, f32_attention_times

    import torch

    if not torch.cuda.is_available():
        print("attention_f32_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import peppa_tpu_torch
    from peppa_tpu_torch.ops.cuda import build

    got = os.path.dirname(os.path.abspath(peppa_tpu_torch.__file__))
    if got != os.path.join(tree, "peppa_tpu_torch"):
        raise RuntimeError(f"imported {got}, not {tree}'s port")
    build.build_all()
    card = card_line()
    record = {"tree": tree}
    if args.only != "bwd":
        record["attention_f32"] = [f32_attention_times(32, 316, None)] + [
            f32_attention_times(1, t, t - 1) for t in ALIGN_T]
    if args.only != "fwd":
        record["attention_bwd_f32"] = [bwd_times(b, t) for b, t in BWD_SHAPES]
        if args.profile:
            record["attention_bwd_f32_kernels"] = [bwd_kernel_ms(b, t)
                                                   for b, t in BWD_SHAPES]
    print(json.dumps({**record, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
