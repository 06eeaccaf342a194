"""Training CLI of the port: `python -m peppa_tpu_torch.run`.

The flags of the repository's `run.py`, plus `--device` (default: the
card; `cpu` for a run on the host):

    python -m peppa_tpu_torch.run --config_file hparams_base.yaml \\
        --limit_train_batches 16 --max_epochs 1

It trains on the extracted episode tree of `data.data_dir` (`PigData`), or
with `--synthetic_data` on synthetic clips.  It reads the same
`hparams_*.yaml` files, stamps the git commit into the config, writes
`version_N/` under `--log_dir`, and exits 75 when a preemption signal
stopped the run (after `checkpoints/preempted.ckpt` was written), so that
a scheduler requeues it; `--auto_resume` then continues from it.

On N cards of one host it runs as one process per card:

    torchrun --nproc_per_node=N -m peppa_tpu_torch.run --config_file ...

Each process joins the group `torchrun` describes (`WORLD_SIZE` > 1:
`utils/dist.py::init_distributed`, NCCL on `cuda:LOCAL_RANK`, gloo with
`--device cpu`) and trains on its slab of every global batch of N x
`data.train.batch_size` rows; rank 0 writes the run directory.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
from argparse import ArgumentParser
from typing import List, Optional

from peppa_tpu_torch.config import Config, default_config


def get_git_commit() -> Optional[str]:
    """The checkout's commit, or None outside a git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_file", help="Configuration file (YAML)",
                   default=None)
    p.add_argument("--limit_train_batches", type=int, default=None)
    p.add_argument("--limit_val_batches", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_time", type=str, default=None,
                   help="DD:HH:MM:SS wall-clock budget")
    p.add_argument("--margin", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log_dir", type=str, default="lightning_logs")
    p.add_argument("--resume_from", type=str, default=None,
                   help="Checkpoint to resume from (e.g. .../last.ckpt)")
    p.add_argument("--auto_resume", action="store_true",
                   help="Resume from the newest preempted.ckpt of a "
                        "matching earlier run (scheduler requeue flow)")
    p.add_argument("--synthetic_data", action="store_true",
                   help="Train on synthetic clips (no media needed)")
    p.add_argument("--synthetic_train", type=int, default=64)
    p.add_argument("--synthetic_val", type=int, default=32)
    p.add_argument("--synthetic_classes", type=int, default=8,
                   help="latent classes in the correlated synthetic "
                        "corpus; >8 makes the task hard enough not to "
                        "saturate at schedule scale")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    logging.getLogger().setLevel(logging.INFO)
    config = (default_config() if args.config_file is None
              else Config.load(args.config_file))
    t = config.training
    for name in ("limit_train_batches", "limit_val_batches", "max_epochs",
                 "max_steps", "max_time", "seed"):
        if getattr(args, name) is not None:
            setattr(t, name, getattr(args, name))
    if args.margin is not None:
        config.margin = args.margin
    if args.synthetic_data:
        config.data.prepare = False
        config.data.extract = False
    config.git_commit = get_git_commit()

    from peppa_tpu_torch.data.datamodule import PigData, SyntheticPigData
    from peppa_tpu_torch.models.convert import pretrained_loader_from_config
    from peppa_tpu_torch.training.checkpoint import (
        consume_preempted_checkpoint, find_preempted_checkpoint)
    from peppa_tpu_torch.training.loop import Trainer

    from peppa_tpu_torch.utils import dist

    data = (SyntheticPigData(config, n_train=args.synthetic_train,
                             n_val=args.synthetic_val,
                             n_classes=args.synthetic_classes)
            if args.synthetic_data else PigData(config))
    resume_from = args.resume_from
    auto_resumed = False
    if args.auto_resume and resume_from is None:
        resume_from = find_preempted_checkpoint(config, args.log_dir)
        if resume_from is not None:
            auto_resumed = True
            logging.info("auto-resume: continuing from %s", resume_from)

    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    device = dist.init_distributed(args.device) if distributed \
        else args.device
    is_main = dist.is_main_process()
    try:
        trainer = Trainer(config, log_dir=args.log_dir, device=device)
        logging.info("Run directory: %s", trainer.version_dir)
        trainer.fit(data,
                    pretrained_loader=pretrained_loader_from_config(config),
                    resume_from=resume_from)
    finally:
        if distributed:
            import torch.distributed

            torch.distributed.destroy_process_group()
    if auto_resumed and is_main:
        # retire the checkpoint this run resumed from, also when it was
        # preempted again (it wrote its own, newer preempted.ckpt)
        consume_preempted_checkpoint(resume_from)
    # EX_TEMPFAIL: preempted after saving checkpoints/preempted.ckpt
    return 75 if trainer.preempted else 0


if __name__ == "__main__":
    sys.exit(main())
