"""The port's tracing (`utils/profiling.py`: `span`, `recording`, `drain`,
`count`, `counters`, `trace`), the spans and counters in the train step,
the service and the prefetcher, the trainer's profile window
(`PEPPA_PROFILE_DIR`, `PEPPA_PROFILE_STEPS`: micro-steps N to 2N - 1 of
`Trainer.fit`, as peppa_tpu/training/loop.py traces them) and
`training/state.py::param_count`, on the CPU."""

import glob
import itertools
import json
import os
import time
import tracemalloc

import jax
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.training.state import param_count as jax_param_count
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import SyntheticPigData
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training.loop import Trainer
from peppa_tpu_torch.training.state import TrainState, param_count
from peppa_tpu_torch.training.step import train_step
from peppa_tpu_torch.utils import profiling
from peppa_tpu_torch.utils.prefetch import Prefetcher
from peppa_tpu_torch.utils.profiling import (count, counters, drain,
                                             recording, span, trace)

TRAIN_PHASES = ("train.forward", "train.loss", "train.backward",
                "train.accumulate")


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _named(events: list, name: str) -> list:
    return [e for e in events if e.get("name") == name]


def _ranges(events: list, name: str) -> list:
    """The host's span ranges called `name` (on the card the trace also
    holds a device-side copy of each)."""
    return [e for e in _named(events, name)
            if e.get("cat") == "user_annotation"]


def _inside(events: list, outer: dict, name: str) -> list:
    return [e for e in _ranges(events, name)
            if outer["ts"] <= e["ts"] <= outer["ts"] + outer["dur"]]


@pytest.fixture
def empty_buffer():
    drain()
    yield
    drain()


def _spans_in_a_loop(n: int) -> None:
    for _ in itertools.repeat(None, n):
        with span("train.step"):
            with span("train.forward"):
                pass


def _peak_and_net(n: int):
    """(the peak of what the Python heap held above its start, what it
    kept) over n passes of `_spans_in_a_loop`."""
    tracemalloc.reset_peak()
    start, _ = tracemalloc.get_traced_memory()
    _spans_in_a_loop(n)
    end, peak = tracemalloc.get_traced_memory()
    return peak - start, end - start


def test_spans_off_record_nothing_and_share_one_object(empty_buffer):
    assert not profiling._on
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("a") is span("b")
    _spans_in_a_loop(10)
    tracemalloc.start()
    try:
        few, many = _peak_and_net(10), _peak_and_net(10_000)
        with recording():
            kept = _peak_and_net(10)
    finally:
        tracemalloc.stop()
    assert few == many and few[1] == 0  # nothing allocated per span
    assert kept[1] > 0  # a kept span is an object in the buffer
    assert len(drain()) == 20
    assert profiling._events == []  # no timing event was made


def test_nesting_gives_parent_and_root_ids(empty_buffer):
    t0 = time.time_ns()
    with recording():
        with span("serve.embed_video"):
            with span("serve.pad"):
                pass
            with span("serve.encode"):
                with span("model.video"):
                    pass
        with span("serve.similarity"):
            pass
    with span("after"):  # recording is off again
        pass
    got = drain()
    assert [s["name"] for s in got] == [
        "serve.embed_video", "serve.pad", "serve.encode", "model.video",
        "serve.similarity"]
    by = {s["name"]: s for s in got}
    root = by["serve.embed_video"]
    assert root["parent"] is None and root["root"] == root["id"]
    for name in ("serve.pad", "serve.encode"):
        assert by[name]["parent"] == root["id"]
    assert by["model.video"]["parent"] == by["serve.encode"]["id"]
    assert {by[n]["root"] for n in by if n != "serve.similarity"} \
        == {root["id"]}
    assert by["serve.similarity"]["root"] == by["serve.similarity"]["id"]
    for s in got:
        assert t0 <= s["start_ns"] <= s["end_ns"] <= time.time_ns()
        assert s["device_ms"] is None  # no card
    assert drain() == []


def test_a_span_under_the_profiler_is_a_range_on_its_clock(empty_buffer):
    with recording(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("train.step"):
            torch.ones(8).sum()
    stamp = drain()[0]
    assert stamp["name"] == "train.step" and stamp["device_ms"] is None
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "train.step"]
    assert len(ranges) == 1
    assert abs(ranges[0].start_ns() - stamp["start_ns"]) < 1_000_000


def test_a_profiler_alone_opens_ranges_and_keeps_nothing(empty_buffer):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("serve.h2d"):
            torch.ones(8).sum()
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() == "serve.h2d"] == ["serve.h2d"]
    assert drain() == []


def test_spans_are_no_ops_under_compile(empty_buffer):
    def f(x):
        with span("model.audio"):
            return (x * 2).sin()

    compiled = torch.compile(f, backend="eager", fullgraph=True)
    x = torch.ones(3)
    with recording():
        torch.testing.assert_close(compiled(x), f(x))
    assert [s["name"] for s in drain()] == ["model.audio"]  # the eager call


def test_counters_are_one_registry():
    before = counters()
    assert before["test.never_counted"] == 0
    count("test.counter")
    count("test.counter", 4)
    after = counters()
    assert after["test.counter"] - before["test.counter"] == 5
    after["test.counter"] = 0  # a snapshot, not the registry
    assert counters()["test.counter"] == before["test.counter"] + 5


def test_trace_of_none_does_nothing(tmp_path, monkeypatch, empty_buffer):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with trace(log_dir):
            with span("inside"):
                torch.ones(3).sum()
            assert not torch.autograd.profiler._is_profiler_enabled
    assert os.listdir(tmp_path) == []
    assert drain() == []


def test_trace_writes_one_trace_with_its_annotated_ranges(tmp_path):
    log_dir = str(tmp_path / "trace")
    with span("outside"):  # no trace active: no range anywhere
        torch.ones(2).sum()
    with trace(log_dir):
        assert torch.autograd.profiler._is_profiler_enabled
        with span("matmul range"):
            torch.randn(16, 16) @ torch.randn(16, 16)
    assert not torch.autograd.profiler._is_profiler_enabled
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    events = _events(files[0])
    assert len(_ranges(events, "matmul range")) == 1
    assert _named(events, "outside") == []
    assert _named(events, "aten::mm")


@pytest.mark.parametrize("steps", [2, 0])
def test_the_trainer_traces_micro_steps_n_to_2n(tmp_path, monkeypatch,
                                                 steps):
    """PEPPA_PROFILE_STEPS = N traces N `train.step` ranges, from
    micro-step N, each over its phases' ranges, `train.optimizer` in every
    k-th (k = 2); with N = 0 the window opens at the first micro-step and
    closes when the fit ends."""
    torch.set_num_threads(2)
    raw = W.fit_raw(str(tmp_path / "data"), batch_size=2)
    raw["training"].update(max_epochs=1, limit_train_batches=5,
                           limit_val_batches=1, num_sanity_val_steps=0)
    cfg = Config.from_dict(raw)
    k = cfg.training.accumulate_grad_batches
    log_dir = str(tmp_path / "profile")
    monkeypatch.setenv("PEPPA_PROFILE_DIR", log_dir)
    monkeypatch.setenv("PEPPA_PROFILE_STEPS", str(steps))
    starts = []  # the micro-step each traced train_step began at
    import peppa_tpu_torch.training.loop as L

    real_step = L.train_step

    def step(state, *a, **kw):
        if torch.autograd.profiler._is_profiler_enabled:
            starts.append(state.step)
        return real_step(state, *a, **kw)

    monkeypatch.setattr(L, "train_step", step)
    trainer = Trainer(cfg, log_dir=str(tmp_path / "runs"), device="cpu")
    state = trainer.fit(SyntheticPigData(cfg, n_train=10, n_val=4))
    assert state.step == 5
    want = [2, 3] if steps else [0, 1, 2, 3, 4]
    assert starts == want
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    events = _events(files[0])
    steps_traced = sorted(_ranges(events, "train.step"),
                          key=lambda e: e["ts"])
    assert len(steps_traced) == len(want)
    for micro_step, outer in zip(want, steps_traced):
        for name in TRAIN_PHASES + ("model.video", "model.audio"):
            assert len(_inside(events, outer, name)) == 1, (micro_step,
                                                            name)
        assert len(_inside(events, outer, "train.optimizer")) == (
            micro_step % k == k - 1)
        assert _inside(events, outer, "train.all_reduce") == []
    assert _ranges(events, "data.wait")
    assert not torch.autograd.profiler._is_profiler_enabled
    for p in glob.glob(str(tmp_path / "runs" / "**" / "*.ckpt*"),
                       recursive=True):
        os.remove(p)


def _tiny_model(tmp_path):
    torch.set_num_threads(2)
    cfg = Config.from_dict(W.tiny_raw(str(tmp_path / "data")))
    return cfg, init_model(cfg, device="cpu")


def test_train_step_spans_nest_under_each_micro_step(tmp_path,
                                                     empty_buffer):
    cfg, model = _tiny_model(tmp_path)
    state = TrainState.create(model, cfg)
    rng = np.random.default_rng(0)
    k = state.accumulate
    with recording():
        for _ in range(k):
            batch = ClipBatch(
                video=rng.integers(0, 256, (2, W.FRAMES, 32, 32, 3),
                                   dtype=np.uint8),
                audio=rng.normal(size=(2, W.SAMPLES)).astype(np.float32),
                video_duration=np.full(2, 0.8, np.float32),
                audio_duration=np.full(2, 0.8, np.float32),
                video_frames=np.full(2, W.FRAMES, np.int32),
                audio_samples=np.full(2, W.SAMPLES, np.int32))
            state, _ = train_step(state, batch, 0, device="cpu")
    got = drain()
    roots = [s for s in got if s["name"] == "train.step"]
    assert len(roots) == k
    for i, root in enumerate(roots):
        mine = [s for s in got if s["root"] == root["id"]]
        names = [s["name"] for s in mine]
        want = ["train.step", "train.forward", "model.video", "model.audio",
                "train.loss", "train.backward", "train.accumulate"]
        if i == k - 1:
            want.append("train.optimizer")
        assert names == want
        children = {s["name"] for s in mine if s["parent"] == root["id"]}
        assert children == set(want) - {"train.step", "model.video",
                                        "model.audio"}
        for s in mine[1:]:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
    assert len(got) == sum(1 for s in got if s["root"] in
                           {r["id"] for r in roots})


def test_the_service_counts_real_and_run_rows(tmp_path, empty_buffer):
    """Batch 4; audio: 3 clips in the 0.8 s bucket and 5 in the 2.0 s one
    (1 + 2 batches, 12 rows); video: 1 clip and 4 clips (1 + 1 batches,
    8 rows)."""
    cfg, model = _tiny_model(tmp_path)
    svc = EncoderService(model, cfg, batch_size=4, device="cpu")
    rng = np.random.default_rng(1)
    waves = [rng.normal(size=n).astype(np.float32)
             for n in (1000, 1280, 700, 2000, 3200, 1500, 3000, 2500)]
    clips = [rng.integers(0, 256, (t, 32, 32, 3), dtype=np.uint8)
             for t in (8, 12, 20, 9, 15)]
    before = counters()
    with recording():
        svc.embed_audio(waves)
        svc.embed_video(clips)
    after = counters()
    got = {name: after[name] - before[name] for name in (
        "serve.rows_real.audio", "serve.rows_run.audio",
        "serve.rows_real.video", "serve.rows_run.video")}
    assert got == {"serve.rows_real.audio": 8, "serve.rows_run.audio": 12,
                   "serve.rows_real.video": 5, "serve.rows_run.video": 8}
    spans = drain()
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["serve.embed_audio",
                                          "serve.embed_video"]
    for root, batches in zip(roots, (3, 2)):
        names = [s["name"] for s in spans if s["root"] == root["id"]]
        for name in ("serve.h2d", "serve.encode", "serve.d2h"):
            assert names.count(name) == batches
        # canonicalising, grouping, then one padded chunk per batch
        assert names.count("serve.pad") == 2 + batches
        tower = "model.audio" if root["name"].endswith("audio") else \
            "model.video"
        assert names.count(tower) == batches


@pytest.mark.parametrize("depth", [2, 0])
def test_the_prefetcher_records_data_wait(depth, empty_buffer):
    batches = [ClipBatch(video=torch.zeros(1, 2, 4, 4, 3, dtype=torch.uint8),
                         audio=torch.zeros(1, 16),
                         video_duration=torch.ones(1),
                         audio_duration=torch.ones(1),
                         video_frames=torch.full((1,), 2, dtype=torch.int32),
                         audio_samples=torch.full((1,), 16,
                                                  dtype=torch.int32))
               for _ in range(3)]
    with recording():
        got = list(Prefetcher(iter(batches), "cpu", depth))
    assert len(got) == 3
    waits = drain()
    # one wait for each batch and one for the end of the stream
    assert [s["name"] for s in waits] == ["data.wait"] * 4
    assert all(s["parent"] is None for s in waits)


def test_param_count_equals_the_jax_packages(tmp_path):
    raw = W.tiny_raw(str(tmp_path / "data"))
    _, variables = jax_init_model(JaxConfig.from_dict(raw),
                                  jax.random.PRNGKey(0),
                                  audio_samples=W.SAMPLES,
                                  video_frames=W.FRAMES)
    model = init_model(Config.from_dict(raw), device="cpu")
    assert param_count(model) == jax_param_count(variables["params"])
    # the running statistics are buffers, not parameters
    assert param_count(model) < sum(t.numel()
                                    for t in model.state_dict().values())
