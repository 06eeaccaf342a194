"""A copy of the benchmark's data at CPU size, for the tests.

`tiny_root(path)` writes `BENCHMARK.json` and `benchmark/{configs,
traffic,metrics,limits}` under `path` with the configurations cut to one
transformer layer, 32x24 frames, 8 kHz audio, float32 and short clips,
and the traffic mixes to a handful of clips.  Widths stay as published.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark.cells import ROOT

TRAFFIC = {
    "train-jitter": dict(duration_mean_s=0.8, duration_sd_s=0.3,
                         duration_min_s=0.3,
                         bucket_cycle=[[0.8, 2], [1.2, 2], [1.6, 1]]),
    "serve-mixed8": dict(batch_size=4, pairs_per_request=3, pool=4,
                         duration_median_s=0.8, duration_clip_s=[0.3, 3.0],
                         rate_per_s=4.0),
    "encode-b256": dict(batch=12, duration_s=0.8, ahead=2, recall_n=3),
}


def tiny_hparams(hp: dict) -> dict:
    hp = json.loads(json.dumps(hp))
    hp["audio"]["num_layers"] = 1
    hp["data"]["target_size"] = [32, 24]
    hp["data"]["audio_sample_rate"] = 8000
    hp["data"]["train"]["batch_size"] = 4
    hp["tpu"]["bucket_durations"] = [0.8, 1.2, 1.6, 2.4]
    hp["training"]["trainer_args"]["accumulate_grad_batches"] = 3
    hp["training"]["trainer_args"]["precision"] = 32
    return hp


def tiny_root(path) -> Path:
    torch.set_num_threads(4)
    path = Path(path)
    (path / "benchmark").mkdir(parents=True, exist_ok=True)
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(ROOT / "benchmark" / sub, path / "benchmark" / sub,
                        dirs_exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", path / "BENCHMARK.json")
    for f in (path / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["hparams"] = tiny_hparams(c["hparams"])
        f.write_text(json.dumps(c))
    for name, values in TRAFFIC.items():
        f = path / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(f.read_text())
        t.update(values)
        f.write_text(json.dumps(t))
    return path
