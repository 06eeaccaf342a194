"""The quality gate of W8A8 int8 inference: `python -m
peppa_tpu_torch.quant_quality [version_dir] [n_val] [--device cpu]`.

The port's counterpart of scripts/quant_quality.py: the best checkpoint of
a trained run (`training/checkpoint.py::load_best_model`), the validation
battery (`evaluation/validation.py::run_validation`, the reference's four
monitor metrics and the two losses, 500 bootstrap subsets) with
`tpu.quantize_int8` off and then on over the same weights, both rows and
their deltas (int8 - float).

Data: the `PigData` validation loaders when the run's data directory has
extracted clips (`out/<w>x<h>`), else the synthetic validation corpus
(`SyntheticPigData`, `n_val` clips a set, labelled as such): the int8
decision for a real model is read from the real-data mode.  On the card
unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional


def quant_quality(version_dir: str, n_val: int = 32, device=None
                  ) -> Dict[str, Dict[str, float]]:
    """{"float": metrics, "int8": metrics} of the run's best checkpoint,
    printed as they come with the deltas after."""
    from peppa_tpu_torch.data.datamodule import PigData, SyntheticPigData
    from peppa_tpu_torch.evaluation.validation import run_validation
    from peppa_tpu_torch.models.dual_encoder import PeppaPig
    from peppa_tpu_torch.training.checkpoint import load_best_model
    from peppa_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model, cfg, ckpt_path = load_best_model(version_dir, device=dev)
    print(f"checkpoint: {ckpt_path}", flush=True)
    w, h = cfg.data.target_size
    if os.path.isdir(os.path.join(cfg.data.data_dir, "out", f"{w}x{h}")):
        data = PigData(cfg)
        print("data: real extracted clips (PigData val loaders)", flush=True)
    else:
        data = SyntheticPigData(cfg, n_val=n_val)
        print(f"data: SYNTHETIC val corpus (n_val={n_val}) — no extracted "
              "media found; rerun with real data for the production quality "
              "gate", flush=True)
    data.setup()

    weights = model.state_dict()
    results = {}
    for label, quant in (("float", False), ("int8", True)):
        if quant != cfg.tpu.quantize_int8:
            cfg.tpu.quantize_int8 = quant
            model = PeppaPig(cfg)
            model.load_state_dict(weights)
            model = model.eval().to(dev)
        metrics = run_validation(model, data.val_loaders(), device=dev,
                                 n_samples=500)
        results[label] = metrics
        print(label, {k: round(v, 4) for k, v in metrics.items()},
              flush=True)
    print("deltas (int8 - float):", flush=True)
    for k in results["float"]:
        if k in results["int8"]:
            print(f"  {k}: {results['int8'][k] - results['float'][k]:+.4f}",
                  flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("version_dir", nargs="?",
                   default="lightning_logs/version_0")
    p.add_argument("n_val", nargs="?", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    quant_quality(args.version_dir, args.n_val, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
