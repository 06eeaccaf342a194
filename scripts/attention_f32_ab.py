#!/usr/bin/env python3
"""Time kernel 1's float32 route of one checkout's port on one CUDA card.

    python3 scripts/attention_f32_ab.py [TREE]

TREE is the root of a checkout (default: this one) whose `peppa_tpu_torch`
is timed with this checkout's `chip_smoke.f32_attention_times`, so that two
trees (a parent and a change, run in turns in one call) are measured
alike.  Builds TREE's kernels, then times `mha_attention` in float32 at the
main paths' shapes (B=32, T=316, no lengths: the float32 `grsa.Embedder`;
B=1, T = 99, 199, 399, 799, key length T - 1: the aligner) back-to-back
and replayed from a CUDA graph, beside SDPA's call on the same inputs, and
holds each against the plain version.  Prints one JSON line, then the
card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
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
    rows = [f32_attention_times(32, 316, None)]
    rows += [f32_attention_times(1, t, t - 1) for t in ALIGN_T]
    print(json.dumps({"tree": tree, "attention_f32": rows, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
