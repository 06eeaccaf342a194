"""Minimal-pairs CLI of the port: `python -m peppa_tpu_torch.targeted_eval`.

The `--run` half of the repository's `evaluation_targeted_triplets.py`,
plus `--device` (default: the card; `cpu` for a run on the host):

    python -m peppa_tpu_torch.targeted_eval --run --versions 0 1 \\
        [--log_dir lightning_logs] [--data_dir data]

For each version (a run directory of the port, the JAX package or the
reference), the best model scores the targeted triplets of
`--data_dir/eval/eval_set_narration_{ADJ,VERB,NOUN}.csv`, with the video
scrambled and not, into
`--results_dir/version_N/minimal_pairs_scores.csv`: the eval set's columns
(`id` first) and `result`, `pos`, `fragment`, `scrambled_video`, in the
JAX CLI's row order, written with the `csv` module.  The eval set's cells
are written as read; `result` as Python prints the float.  `--plot` and
its tables need pandas and matplotlib and are not ported.
"""

from __future__ import annotations

import csv
import logging
import os
from argparse import ArgumentParser
from typing import List, Optional

FRAGMENTS = ["narration"]  # reference evaluation_targeted_triplets.py:20
POS_TAGS = ["ADJ", "VERB", "NOUN"]  # reference :21
RESULTS_DIR = os.path.join("results", "targeted_triplets")


def evaluate(version, log_dir: str = "lightning_logs", data_dir: str = "data",
             batch_size: int = 8, results_dir: str = RESULTS_DIR,
             device=None) -> str:
    """Score one run version; returns the CSV's path."""
    from peppa_tpu_torch.evaluation.evaluation import make_predict
    from peppa_tpu_torch.evaluation.targeted import (get_eval_set_info,
                                                     targeted_triplet_score)
    from peppa_tpu_torch.training.checkpoint import load_best_model

    dirname = os.path.join(log_dir, f"version_{version}")
    model, config, _ = load_best_model(dirname, device=device)
    predict_fn = make_predict(model, device)
    header: List[str] = []
    rows: List[List[str]] = []
    for fragment in FRAGMENTS:
        for pos in POS_TAGS:
            for scrambled in (False, True):
                logging.info("Evaluating %s/%s scrambled=%s", fragment, pos,
                             scrambled)
                scores = targeted_triplet_score(
                    fragment, pos, predict_fn, batch_size=batch_size,
                    scrambled_video=scrambled,
                    target_size=config.data.target_size,
                    audio_sample_rate=config.data.audio_sample_rate,
                    data_dir=data_dir)
                columns, info = get_eval_set_info(fragment, pos, data_dir)
                if len(scores) != len(info):
                    raise AssertionError(f"{len(scores)} scores vs "
                                         f"{len(info)} eval rows")
                cols = columns + ["result", "pos", "fragment",
                                  "scrambled_video"]
                if header and header != cols:
                    raise ValueError(f"eval set {pos}: columns {columns} "
                                     f"differ from the first set's")
                header = cols
                rows += [[r[c] for c in columns]
                         + [repr(float(s)), pos, fragment, str(scrambled)]
                         for r, s in zip(info, scores)]
    outdir = os.path.join(results_dir, f"version_{version}")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "minimal_pairs_scores.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)
    logging.info("Wrote %s", path)
    return path


def parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", action="store_true")
    p.add_argument("--versions", type=str, nargs="+", default=[])
    p.add_argument("--log_dir", type=str, default="lightning_logs")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--results_dir", type=str, default=RESULTS_DIR)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    logging.getLogger().setLevel(logging.INFO)
    if args.run:
        for version in args.versions:
            evaluate(version, log_dir=args.log_dir, data_dir=args.data_dir,
                     results_dir=args.results_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
