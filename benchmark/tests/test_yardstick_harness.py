"""The harness on the CPU at test size: a cell, a mix and a metric added as
files are found by name; the result line's keys; no card, no result; and
a run whose timed path is broken underneath comes out not correct."""

import json
import sys
import types

import pytest
import torch

from benchmark import run as bench_run
from benchmark.cells import Bench
from benchmark.tests.tiny import tiny_root
from peppa_tpu_torch import serving
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from peppa_tpu_torch.training import optimization
from peppa_tpu_torch.training import step as port_step
from peppa_tpu_torch.training.state import TrainState

SEED = 2 ** 31 + 101
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run(root, workload, seconds=0.5, traced=False, limits=None):
    return bench_run.run_cell(workload, SEED, seconds, traced, "cpu",
                              root=root, limits=limits)


def add_cell(root):
    """A configuration, a mix, a metric and a cell, as a later change adds
    them: new files and new entries, no edit of a file the harness has."""
    d = root / "benchmark"
    cfg = json.loads((d / "configs" / "peppa-base.json").read_text())
    cfg["hparams"]["video"]["midplanes_multiple"] = 64
    (d / "configs" / "fake-config.json").write_text(json.dumps(cfg))
    mix = json.loads((d / "traffic" / "serve-mixed8.json").read_text())
    mix.update(pool=2, pairs_per_request=2, batch_size=2)
    (d / "traffic" / "fake-mix.json").write_text(json.dumps(mix))
    (d / "metrics" / "fake.rows_run.py").write_text(
        "def read(run):\n    return sum(r['rows_run'] for r in "
        "run['requests'])\n")
    (d / "limits" / "fake-cell.json").write_text(
        (d / "limits" / "base-serve-mixed8.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="fake-config",
                                 file="benchmark/configs/fake-config.json"))
    bench["workloads"].append({"name": "fake-cell", "config": "fake-config",
                               "traffic": "fake-mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "embed_pairs_per_s":
            m["workloads"].append("fake-cell")
    bench["per_layer"].append({
        "name": "fake.rows_run", "unit": "rows", "better": "lower",
        "source": "program_counter", "layer": "serving",
        "moves": "embed_pairs_per_s", "workloads": ["fake-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    add_cell(root)
    plain = run(root, "fake-cell", seconds=0.3)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"embed_pairs_per_s", "setup_s"}
    traced = run(root, "fake-cell", seconds=0.3, traced=True)
    assert traced["correct"]
    assert traced["metrics"]["fake.rows_run"]["value"] \
        == sum(r["rows_run"] for r in traced["requests"]) > 0
    assert traced["metrics"]["fake.rows_run"]["unit"] == "rows"
    line = bench_run.result_line(traced, {"name": "cpu",
                                          "power_limit_w": None}, 1)
    assert list(line)[:5] == LINE_KEYS
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)


def test_result_line_keys(root):
    rec = run(root, "prod-encode-b256", seconds=0.3)
    line = bench_run.result_line(rec, {"name": "cpu", "power_limit_w": None},
                                 1)
    assert list(line) == LINE_KEYS + ["checks"]
    assert set(line["metrics"]) == {"embed_pairs_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    rc = bench_run.main(["--workload", "prod-train-16x4", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_jax_in_the_process_is_found(monkeypatch):
    assert "peppa_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "peppa_tpu.ops",
                        types.ModuleType("peppa_tpu.ops"))
    assert bench_run.forbidden_modules() == ["jax", "peppa_tpu"]


def test_limits_are_the_repositorys():
    bench = Bench()
    for w in bench.spec["workloads"]:
        limits = bench.limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())


# ------------------------------------------------------------------ faults
def _half_rows(batch):
    half = batch.video.shape[0] // 2
    return type(batch)(**{k: getattr(batch, k)[:half] for k in (
        "video", "audio", "video_duration", "audio_duration",
        "video_frames", "audio_samples")})


def _state_unchanged(monkeypatch):
    def apply_gradients(self):
        self.step += 1
    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def _rate_times(factor):
    def fault(monkeypatch):
        real = optimization.schedule_fn
        monkeypatch.setattr(optimization, "schedule_fn",
                            lambda *a: lambda step: factor * real(*a)(step))
    return fault


_params_unmoved = _rate_times(0.0)
_params_unmoved.__name__ = "_params_unmoved"
_params_moved_double = _rate_times(2.0)
_params_moved_double.__name__ = "_params_moved_double"


def _train_half_batch(monkeypatch):
    from benchmark.kinds import train as driver
    real = driver.train_step
    monkeypatch.setattr(driver, "train_step",
                        lambda state, batch, seed, device=None: real(
                            state, _half_rows(batch), seed, device))


def _train_loss_altered(monkeypatch):
    real = port_step.triplet_loss
    monkeypatch.setattr(port_step, "triplet_loss",
                        lambda v, a, margin=0.2: real(v, a, margin) * 1.1)


def _service_half_batch(monkeypatch):
    real = serving.EncoderService._run_bucketed

    def run_bucketed(self, items, bucket_of, fn):
        out = real(self, items, bucket_of, fn)
        half = len(out) // 2
        out[half:] = out[:half].mean(axis=0)
        return out
    monkeypatch.setattr(serving.EncoderService, "_run_bucketed",
                        run_bucketed)


def _service_answer_altered(monkeypatch):
    real = serving.EncoderService._encode

    def encode(self, fn, batch):
        out = real(self, fn, batch)
        out[0, 0] += 0.05
        return out
    monkeypatch.setattr(serving.EncoderService, "_encode", encode)


def _model_half_batch(monkeypatch):
    real = PeppaPig.encode_video

    def encode_video(self, video, *a, **kw):
        out = real(self, video, *a, **kw)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half].mean(0, keepdim=True)
                          .expand(out.shape[0] - half, -1)])
    monkeypatch.setattr(PeppaPig, "encode_video", encode_video)


def _encode_loss_half_batch(monkeypatch):
    from benchmark.kinds import encode as driver
    real = driver.triplet_loss
    monkeypatch.setattr(driver, "triplet_loss",
                        lambda v, a, margin=0.2: real(
                            v[:len(v) // 2], a[:len(a) // 2], margin))


def _recall_altered(monkeypatch):
    from benchmark.kinds import encode as driver
    real = driver.recall_at_n
    monkeypatch.setattr(driver, "recall_at_n",
                        lambda *a, **kw: 1.0 - real(*a, **kw))


FAULTS = {
    "prod-train-16x4": [None, _state_unchanged, _params_unmoved,
                        _params_moved_double, _train_half_batch,
                        _train_loss_altered],
    "base-serve-mixed8": [None, _service_half_batch,
                          _service_answer_altered],
    "prod-encode-b256": [None, _model_half_batch, _encode_loss_half_batch,
                         _recall_altered],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, faults in FAULTS.items() for f in faults],
    ids=lambda x: x if isinstance(x, str) else getattr(x, "__name__",
                                                       "sound"))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, workload,
                                            fault):
    if fault is not None:
        fault(monkeypatch)
    rec = run(root, workload, seconds=0.3, limits=Bench().limits(workload))
    assert rec["correct"] is (fault is None), rec["checks"]
