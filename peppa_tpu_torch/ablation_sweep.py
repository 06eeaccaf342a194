"""The paper's seven-condition ablation sweep, end to end, from one command.

The counterpart of the root script scripts/ablation_sweep.py: every
condition of `config.conditions(base)` through

    Trainer.fit -> save_conditions -> full_run -> merge_scores
    -> format_tables

on a synthetic episode tree it writes, giving results/scores.csv (one row
per version, fragment type and scrambling: 28) and
results/scores_{dialog,narration}.tex (one row per condition).  At
`tiny_base`'s shapes it is the proof that every condition trains and
scores; with a base at full width it trains the published towers.  No
pretrained file is read (the JAX script's `fit` has no loader either):
the `pretraining_*` conditions differ from `base` in the normalisation
statistics they pick, and train from the seeded init.

    python -m peppa_tpu_torch.ablation_sweep [--work-dir DIR] [--epochs 1]
        [--n-samples 50] [--device cpu]

runs `tiny_base` on the card (without `--device cpu` it raises where
there is none).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from peppa_tpu_torch.config import Config, conditions, save_conditions
from peppa_tpu_torch.utils.device import resolve_device

ARTIFACTS = ("scores.csv", "scores_dialog.tex", "scores_narration.tex")


def tiny_base(data_dir: str, target_size: Sequence[int] = (32, 24),
              sample_rate: int = 800, max_epochs: int = 1,
              limit_train_batches: int = 4) -> Config:
    """The JAX script's tiny base configuration, from which the conditions
    derive: 32x24 frames, 800 Hz audio, one transformer layer, float32,
    batches of 4, `limit_train_batches` batches an epoch, 2 validation
    batches, no sanity validation."""
    cfg = Config()
    cfg.data.data_dir = data_dir
    cfg.data.target_size = tuple(target_size)
    cfg.data.audio_sample_rate = sample_rate
    cfg.data.prepare = False
    cfg.data.extract = False
    cfg.data.iterable = False
    cfg.data.num_workers = 0
    cfg.data.train.batch_size = 4
    cfg.data.val.batch_size = 4
    cfg.audio.num_layers = 1
    cfg.training.precision = "fp32"
    cfg.training.max_epochs = max_epochs
    cfg.training.limit_train_batches = limit_train_batches
    cfg.training.limit_val_batches = 2
    cfg.training.num_sanity_val_steps = 0
    cfg.training.log_every_n_steps = 2
    cfg.optimizer.t_total = max(limit_train_batches * max_epochs, 2)
    cfg.tpu.use_pallas = False
    cfg.tpu.mesh_shape = (1, 1)
    return cfg


def write_tree(data_dir: str, base: Config, episodes_train: int = 4,
               episodes_val: int = 2, clip_seconds: float = 7.0,
               seed: int = 0) -> None:
    """The sweep's synthetic episode tree at `base`'s frame size and
    sample rate: dialog train episodes 1..`episodes_train`, dialog val
    from 197 and narration val from 1 (`episodes_val` each), two
    correlated clips an episode."""
    from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree

    ts, sr = tuple(base.data.target_size), base.data.audio_sample_rate
    for seed_i, (frag, eps) in enumerate((
            ("dialog", range(1, episodes_train + 1)),
            ("dialog", range(197, 197 + episodes_val)),
            ("narration", range(1, episodes_val + 1)))):
        make_synthetic_episode_tree(
            data_dir, target_size=ts, fragment_type=frag, episodes=eps,
            clips_per_episode=2, clip_seconds=clip_seconds, sample_rate=sr,
            seed=seed + seed_i, correlated=True)


def run_sweep(work_dir: str, *, base: Optional[Config] = None,
              n_samples: int = 50, episodes_train: int = 4,
              episodes_val: int = 2, clip_seconds: float = 7.0,
              seed: int = 0,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[Dict[str, List[int]], str]:
    """Train every condition of `conditions(base)` (None: `tiny_base`
    under `work_dir`/data) into `work_dir`/lightning_logs, write
    `work_dir`/conditions.yaml, score every version and write the tables
    into `work_dir`/results, all on `device` (None: the card; raises
    without CUDA).  Returns (condition -> versions, the results
    directory); raises when a condition has no matching run."""
    import yaml

    from peppa_tpu_torch.data.datamodule import PigData
    from peppa_tpu_torch.evaluation.evaluation import (format_tables,
                                                       full_run, merge_scores)
    from peppa_tpu_torch.training.loop import Trainer

    dev = resolve_device(device)
    data_dir = os.path.join(work_dir, "data")
    log_dir = os.path.join(work_dir, "lightning_logs")
    results_dir = os.path.join(work_dir, "results")
    if base is None:
        base = tiny_base(data_dir)
    write_tree(base.data.data_dir, base, episodes_train, episodes_val,
               clip_seconds, seed)

    for name, cfg in conditions(base).items():
        print(f"=== training condition {name!r}", flush=True)
        Trainer(cfg, log_dir=log_dir, device=dev).fit(PigData(cfg))

    cond_path = os.path.join(work_dir, "conditions.yaml")
    save_conditions(log_dir, cond_path, base=base)
    with open(cond_path) as f:
        cond_map = yaml.safe_load(f)
    missing = [k for k, v in cond_map.items() if not v]
    if missing:
        raise RuntimeError(f"conditions with no matching run: {missing}")

    versions = sorted(v for vals in cond_map.values() for v in vals)
    full_run(versions=versions, log_dir=log_dir, results_dir=results_dir,
             n_samples=n_samples, device=dev)
    merge_scores(versions=versions, results_dir=results_dir)
    format_tables(results_dir=results_dir)
    return cond_map, results_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default=os.path.join(
        tempfile.gettempdir(), "ablation_sweep"))
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--n-samples", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    base = tiny_base(os.path.join(args.work_dir, "data"),
                     max_epochs=args.epochs)
    cond_map, results_dir = run_sweep(args.work_dir, base=base,
                                      n_samples=args.n_samples, device=dev)
    print("conditions:", cond_map)
    for f in ARTIFACTS:
        path = os.path.join(results_dir, f)
        if not os.path.exists(path):
            raise RuntimeError(f"the sweep wrote no {path}")
        print("artifact:", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
