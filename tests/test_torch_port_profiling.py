"""The port's profiler hooks (`utils/profiling.py`: `trace`, `annotate`),
the trainer's profile window (`PEPPA_PROFILE_DIR`, `PEPPA_PROFILE_STEPS`:
micro-steps N to 2N - 1 of `Trainer.fit`, as peppa_tpu/training/loop.py
traces them) and `training/state.py::param_count`, on the CPU."""

import glob
import json
import os

import jax
import pytest
import torch

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.training.state import param_count as jax_param_count
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import SyntheticPigData
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.training.loop import Trainer
from peppa_tpu_torch.training.state import param_count
from peppa_tpu_torch.utils.profiling import annotate, trace


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _named(events: list, name: str) -> list:
    return [e for e in events if e.get("name") == name]


def _ranges(events: list, name: str) -> list:
    """The host's `annotate` ranges called `name` (on the card the trace
    also holds a device-side copy of each)."""
    return [e for e in _named(events, name)
            if e.get("cat") == "user_annotation"]


def test_trace_of_none_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with trace(log_dir):
            with annotate("inside"):
                torch.ones(3).sum()
            assert not torch.autograd.profiler._is_profiler_enabled
    assert os.listdir(tmp_path) == []


def test_trace_writes_one_trace_with_its_annotated_ranges(tmp_path):
    log_dir = str(tmp_path / "trace")
    with annotate("outside"):  # no trace active: no range anywhere
        torch.ones(2).sum()
    with trace(log_dir):
        assert torch.autograd.profiler._is_profiler_enabled
        with annotate("matmul range"):
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
    """PEPPA_PROFILE_STEPS = N traces N `train_step` ranges, from
    micro-step N; with N = 0 the window opens at the first micro-step and
    closes when the fit ends."""
    torch.set_num_threads(2)
    raw = W.fit_raw(str(tmp_path / "data"), batch_size=2)
    raw["training"].update(max_epochs=1, limit_train_batches=5,
                           limit_val_batches=1, num_sanity_val_steps=0)
    cfg = Config.from_dict(raw)
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
    assert len(_ranges(events, "train_step")) == len(want)
    assert not torch.autograd.profiler._is_profiler_enabled
    for p in glob.glob(str(tmp_path / "runs" / "**" / "*.ckpt*"),
                       recursive=True):
        os.remove(p)


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
