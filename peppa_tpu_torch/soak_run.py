"""Drive a training run to the end of its schedule through preemptions and
crashes: `python -m peppa_tpu_torch.soak_run <config.yaml> <log_dir> [run
args...]`.

The port's counterpart of scripts/soak_run.sh, the same loop over `python
-m peppa_tpu_torch.run` (run from the repository's root, as the script
runs `run.py` there), at most `MAX_ATTEMPTS` attempts (environment,
default 12):

- exit 0: done;
- exit 75 (preempted: the run wrote `checkpoints/preempted.ckpt`): the
  next attempt adds `--auto_resume`;
- any other exit (a crash): after a pause of 30 s the next attempt resumes
  `--resume_from` the newest `version_*/checkpoints/last.ckpt` under
  `log_dir` by modification time, or starts afresh when there is none.

`python -m peppa_tpu_torch.soak_report` then checks the resume chain the
attempts leave (one version directory each).
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

EX_TEMPFAIL = 75  # a preempted run (`peppa_tpu_torch/run.py`)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = (sys.executable, "-m", "peppa_tpu_torch.run")


def newest_last_checkpoint(log_dir: str) -> Optional[str]:
    found = glob.glob(os.path.join(log_dir, "version_*", "checkpoints",
                                   "last.ckpt"))
    return max(found, key=os.path.getmtime) if found else None


def soak(config_file: str, log_dir: str, run_args: Sequence[str] = (),
         command: Sequence[str] = RUN, pause: float = 30.0,
         max_attempts: Optional[int] = None,
         sleep: Callable[[float], None] = time.sleep,
         timeout: Optional[float] = None
         ) -> Tuple[int, List[Tuple[List[str], int]]]:
    """(0 when an attempt completed, else 1; each attempt's (argument list,
    exit code)).  An attempt runs `command` + --config_file, --log_dir, the
    resume arguments and `run_args`, from the repository's root; one that
    outlasts `timeout` seconds is killed and raises."""
    if max_attempts is None:
        max_attempts = int(os.environ.get("MAX_ATTEMPTS", "12"))
    attempts: List[Tuple[List[str], int]] = []
    resume: List[str] = []
    for attempt in range(1, max_attempts + 1):
        print(f"=== soak_run attempt {attempt}: "
              f"{' '.join(resume) or 'fresh'} ===", flush=True)
        argv = [*command, "--config_file", config_file, "--log_dir",
                log_dir, *resume, *run_args]
        rc = subprocess.run(argv, cwd=ROOT, timeout=timeout).returncode
        attempts.append((argv, rc))
        if rc == 0:
            print(f"=== soak_run: completed on attempt {attempt} ===",
                  flush=True)
            return 0, attempts
        if rc == EX_TEMPFAIL:
            resume = ["--auto_resume"]
            continue
        last = newest_last_checkpoint(log_dir)
        if last is not None:
            print(f"=== soak_run: rc={rc}, resuming from {last} ===",
                  flush=True)
            resume = ["--resume_from", last]
        else:
            print(f"=== soak_run: rc={rc} with no checkpoint yet; retrying "
                  "fresh ===", flush=True)
            resume = []
        sleep(pause)  # a crashed run's resources settle before the next
    print(f"=== soak_run: giving up after {max_attempts} attempts ===",
          flush=True)
    return 1, attempts


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__.splitlines()[0] + "\nusage: python -m "
              "peppa_tpu_torch.soak_run <config.yaml> <log_dir> "
              "[run args...]", file=sys.stderr)
        return 2
    config_file, log_dir = (os.path.abspath(p) for p in argv[:2])
    return soak(config_file, log_dir, argv[2:])[0]


if __name__ == "__main__":
    sys.exit(main())
