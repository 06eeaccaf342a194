"""One driver per kind of traffic (`train`, `serve`, `encode`).

`run(ctx)` of a driver takes the cell's context (`benchmark/run.py`:
`hp`, `traffic`, `seed`, `seconds`, `traced`, `device`, `t0`, `limits`)
and returns the run's record: `setup_s`, `window_s`, the work done, the
trace's reduction when traced, `memory_peak_bytes`, and `checks`, each
number that decides `correct` beside its limit.  It builds the program,
warms every shape its traffic uses, measures, frees the program, then
runs the plain reference on what the window produced.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import torch


def peak_bytes(device) -> Optional[int]:
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def alloc_retries(device) -> Optional[int]:
    """The caching allocator's count of `cudaMalloc` calls retried after
    freeing its cache (each a stall of the host); None off the card."""
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_stats(device).get("num_alloc_retries", 0))


def release(device) -> None:
    """Return the freed program's memory before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def checks(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limited number."""
    missing = sorted(limits.keys() - values.keys())
    if missing:
        raise KeyError(f"no reading of {missing}")
    return {k: {"value": float(values[k]), "limit": limits[k]}
            for k in limits}
