#!/usr/bin/env python3
"""Time the triplet loss of one checkout's port on one CUDA card.

    python3 scripts/loss_ab.py [TREE]

TREE is the root of a checkout (default: this one) whose `peppa_tpu_torch`
is timed with this checkout's `chip_smoke.loss_times`, so that two trees (a
parent and a change, run in turns in one call) are measured alike.  Builds
TREE's kernels, then at B = 8 and 32, D = 512 times the loss as the eval
step calls it (no autograd) and as a train micro-step calls it (forward +
gradient through autograd), back-to-back and replayed from a CUDA graph.
Prints one JSON line, then the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, loss_times

    import torch

    if not torch.cuda.is_available():
        print("loss_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import peppa_tpu_torch
    from peppa_tpu_torch.ops.cuda import build

    got = os.path.dirname(os.path.abspath(peppa_tpu_torch.__file__))
    if got != os.path.join(tree, "peppa_tpu_torch"):
        raise RuntimeError(f"imported {got}, not {tree}'s port")
    build.build_all()
    card = card_line()
    rows = [loss_times(b) for b in (8, 32)]
    print(json.dumps({"tree": tree, "loss": rows, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
