"""Evaluation CLI of the port: `python -m peppa_tpu_torch.evaluate`.

The flags of the repository's `evaluate.py`, plus `--device` (default: the
card; `cpu` for a run on the host):

    python -m peppa_tpu_torch.evaluate --versions 0 1 2 \\
        [--log_dir lightning_logs] [--results_dir results] [--n_samples 500]

Each `--log_dir/version_N` may be a run directory of the port, of the JAX
package (flax-msgpack checkpoints) or of the reference (Lightning
checkpoints).  Its best checkpoint is scored on the val episodes of its
config's `data.data_dir` (`evaluation/evaluation.py::full_run`) into
`--results_dir/full_scores_vN.pt`.  Without `--versions`, the versions of
`conditions.yaml` are scored.
"""

from __future__ import annotations

import logging
from argparse import ArgumentParser
from typing import List, Optional

from peppa_tpu_torch.evaluation.evaluation import full_run


def parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--versions", type=str, nargs="+")
    p.add_argument("--log_dir", type=str, default="lightning_logs")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--n_samples", type=int, default=500)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    logging.getLogger().setLevel(logging.INFO)
    full_run(versions=args.versions, log_dir=args.log_dir,
             results_dir=args.results_dir, n_samples=args.n_samples,
             device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
