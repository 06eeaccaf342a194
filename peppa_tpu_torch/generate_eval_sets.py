"""Write the minimal-pairs eval sets from the realigned transcripts.

    python -m peppa_tpu_torch.generate_eval_sets [--min-occurrences N]
        [--min-phrase-duration S] [--realign-dir D] [--eval-dir E]

The port's counterpart of the root generate_targeted_triplets_eval_sets.py
(reference generate_targeted_triplets_eval_sets.py), with the same flags
and output files: `{eval-dir}/eval_set_narration_{ADJ,VERB,NOUN}.csv` from
the gentle-style JSONs under `--realign-dir`
(`evaluation/eval_set_generation.py::generate`).  It runs no model.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from peppa_tpu_torch.evaluation.eval_set_generation import generate


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--min-occurrences", type=int, default=10,
                        help="Minimum occurrences in val data for a word")
    parser.add_argument("--min-phrase-duration", type=float, default=0.3,
                        help="Minimum duration of a phrase (seconds)")
    parser.add_argument("--realign-dir", default="data/out/realign")
    parser.add_argument("--eval-dir", default="data/eval")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.getLogger().setLevel(logging.INFO)
    args = get_args(argv)
    generate(realign_dir=args.realign_dir, eval_dir=args.eval_dir,
             min_occurrences=args.min_occurrences,
             min_phrase_duration=args.min_phrase_duration)


if __name__ == "__main__":
    main()
