"""The port's serving bench (`peppa_tpu_torch/serving_bench.py`,
scripts/serving_bench.py's counterpart) on the CPU, at the tiny
configuration of test_torch_port_slice.py (2 transformer layers, 32x32
video, 16 kHz; two buckets, 0.1 and 0.2 s): one latency row per bucket
with the JAX script's keys; the artifact, exported for the CPU alone and
served in process, equal bit for bit to the live model at its batch size;
the child process, which imports `peppa_tpu_torch` alone with JAX
blocked, giving the same embeddings."""

import json

import numpy as np
import pytest

from peppa_tpu_torch import serving_bench
from peppa_tpu_torch.config import Config

RAW = {  # tests/test_torch_port_slice.py's tiny configuration
    "data": {"target_size": [32, 32], "audio_sample_rate": 16000},
    "audio": {"num_layers": 2},
    "training": {"trainer_args": {"precision": 32}},
    "tpu": {"bucket_durations": [0.1, 0.2]},
}


@pytest.fixture(scope="module")
def record():
    mp = pytest.MonkeyPatch()
    mp.setattr(serving_bench, "default_config",
               lambda: Config.from_dict(RAW))
    try:
        return serving_bench.main(["--requests", "2", "--batch", "3"],
                                  device="cpu")
    finally:
        mp.undo()


def test_record_keys_and_latency_rows(record):
    assert set(record) == {"warmup_s", "n_programs", "batch",
                           "dispatch_overhead_ms", "latency",
                           "export_roundtrip", "device"}
    assert record["n_programs"] == 4 and record["batch"] == 3
    assert record["device"] == {"name": None, "power_limit_w": None}
    rows = record["latency"]
    assert [r["bucket_s"] for r in rows] == [0.1, 0.2]
    for row, (samples, frames) in zip(rows, ((1600, 1), (3200, 2))):
        assert set(row) == {"bucket_s", "audio_ms", "video_ms", "audio_mb",
                            "video_mb"}
        for kind in ("audio_ms", "video_ms"):
            assert 0 < row[kind]["p50"] <= row[kind]["max"]
        assert row["audio_mb"] == round(3 * samples * 4 / 1e6, 1)
        assert row["video_mb"] == round(3 * frames * 32 * 32 * 3 / 1e6, 1)


def test_artifact_equals_live_and_the_cpu_child(record):
    trip = record["export_roundtrip"]
    assert trip["batch"] == 2 and trip["bucket_s"] == 0.1
    assert trip["platforms"] == ["cpu"]
    for key in ("exported_cpu_vs_live", "exported_cpu_vs_exported_cpu"):
        for kind in ("audio", "video"):
            assert trip[key][kind]["max_abs"] == 0.0, (key, kind)
            assert trip[key][kind]["min_cos"] > 1 - 1e-6
    assert trip["cpu_child_s"] > 0 and trip["load_s"] >= 0


def test_agree_reads_max_abs_and_least_row_cosine():
    x = np.array([[1.0, 0.0], [0.0, 2.0]])
    y = np.array([[1.0, 0.0], [2.0, 0.0]])
    assert serving_bench.agree(x, y) == {"max_abs": 2.0, "min_cos": 0.0}


def test_cli_prints_the_record(record, capsys, monkeypatch):
    """`main` parses the JAX script's flags and prints the record as one
    JSON object."""
    seen = []

    def start(*args):
        seen.append(args)
        return _Done(record)

    monkeypatch.setattr(serving_bench, "start", start)
    assert serving_bench.main(["--requests", "5"]) is record
    assert seen == [(5, 8, None)]
    assert json.loads(capsys.readouterr().out) == record


class _Done:
    def __init__(self, record):
        self.record = record

    def finish(self):
        return self.record

    def close(self):
        pass
