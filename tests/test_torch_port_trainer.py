"""The port's trainer, checkpoints and run directories on the CPU, case for
case after tests/test_training_loop.py (tests/test_torch_port_run.py has
the CLI and one `fit` against the JAX package's `Trainer`).

Small sizes: 32x32 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, R(2+1)D-18, float32, micro-batches of 4 clips of 0.8 s.

Resumes are held bit for bit: the losses logged after the resume equal a
continuous run's, and so does the final state, tensor for tensor.
"""

import csv
import json
import os
import signal

import numpy as np
import pytest
import torch

import peppa_tpu_torch.training.loop as L
from peppa_tpu.training.collapse import CollapseDetector as JaxCollapse
from peppa_tpu.training.loggers import MetricsLogger as JaxLogger
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import SyntheticPigData
from peppa_tpu_torch.models.dual_encoder import PeppaPig, init_model
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training.checkpoint import (CheckpointManager,
                                                 load_best_model,
                                                 load_checkpoint)
from peppa_tpu_torch.training.collapse import CollapseDetector
from peppa_tpu_torch.training.loggers import MetricsLogger
from peppa_tpu_torch.training.preemption import PreemptionGuard
from peppa_tpu_torch.training.state import TrainState

RAW = {
    "data": {"target_size": [32, 32], "audio_sample_rate": 800,
             "train": {"batch_size": 4, "duration": 0.8},
             "val": {"batch_size": 4, "duration": 0.8}},
    "audio": {"num_layers": 2},
    "training": {"trainer_args": {"precision": 32,
                                  "accumulate_grad_batches": 2},
                 "max_epochs": 1, "num_sanity_val_steps": 1,
                 "limit_train_batches": 2, "limit_val_batches": 2,
                 "log_every_n_steps": 1},
    "optimizer": {"t_total": 100},
    "tpu": {"bucket_durations": [0.8, 2.0], "mesh_shape": [1, 1],
            "donate_state": False},
}


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint at this size holds about 0.9 GB (55M parameters, two
    moments and the accumulation buffer): remove them after each test."""
    yield
    for p in tmp_path.rglob("*.ckpt*"):
        if p.is_file():
            p.unlink()


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers on few cores: two intra-op threads
    each keep them from oversubscribing the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


_INITS = {}


@pytest.fixture(autouse=True)
def _init_once(monkeypatch):
    """`init_model(config, seed)` is deterministic and takes seconds at
    this size (55M truncated-normal draws): the trainer's call draws each
    (model config, seed) once and copies it after."""
    real = L.init_model

    def init_model(config, seed=0, device=None):
        key = (repr(config.audio), repr(config.video),
               config.training.precision, seed)
        if key not in _INITS:
            _INITS[key] = real(config, seed=seed, device="cpu").state_dict()
        model = PeppaPig(config)
        model.load_state_dict(_INITS[key])
        return model.eval().to(device)

    monkeypatch.setattr(L, "init_model", init_model)


def tiny_config(**training) -> Config:
    cfg = Config.from_dict(RAW)
    for k, v in training.items():
        setattr(cfg.training, k, v)
    return cfg


def fit(tmp_path, tag, n_train=12, n_val=8, resume_from=None, data=None,
        **training):
    cfg = tiny_config(**training)
    trainer = L.Trainer(cfg, log_dir=str(tmp_path / tag), device="cpu")
    state = trainer.fit(data or SyntheticPigData(cfg, n_train=n_train,
                                                 n_val=n_val),
                        resume_from=resume_from)
    return trainer, state


def rows(version_dir):
    with open(os.path.join(version_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def losses(version_dir):
    return {int(r["step"]): float(r["train_loss"])
            for r in rows(version_dir) if r.get("train_loss")}


def meta(version_dir, name="last.ckpt"):
    with open(os.path.join(version_dir, "checkpoints", name + ".json")) as f:
        return json.load(f)


def assert_same_state(a: TrainState, b: TrainState):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for part in ("model", "acc_grads"):
        assert sa[part].keys() == sb[part].keys()
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    oa, ob = sa["optimizer"], sb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)


def test_trainer_end_to_end(tmp_path):
    trainer, state = fit(tmp_path, "logs")
    assert state.step == 2 and state.optimizer.param_groups[0]["step"] == 1
    vdir = trainer.version_dir
    assert os.path.basename(vdir) == "version_0"
    assert os.path.exists(os.path.join(vdir, "hparams.yaml"))
    ckpts = sorted(os.listdir(os.path.join(vdir, "checkpoints")))
    assert "last.ckpt" in ckpts and "last.ckpt.json" in ckpts
    best = [c for c in ckpts if c.startswith("epoch=0-")
            and c.endswith(".ckpt")]
    assert len(best) == 2
    # one disk write: the monitor files are hard links of last.ckpt
    inodes = {os.stat(os.path.join(vdir, "checkpoints", c)).st_ino
              for c in best + ["last.ckpt"]}
    assert len(inodes) == 1
    val = [r for r in rows(vdir) if r.get("val_loss")]
    assert len(val) == 1 and all(np.isfinite(float(val[0][k])) for k in (
        "val_loss", "val_rec_fixed", "valnarr_loss", "valnarr_rec_fixed",
        "val_triplet", "valnarr_triplet"))

    model, config, path = load_best_model(vdir, device="cpu")
    assert path.endswith(".ckpt") and os.path.basename(path) in best
    assert config.to_dict() == trainer.config.to_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    fresh = TrainState.create(init_model(config, seed=1, device="cpu"),
                              config)
    restored, m = load_checkpoint(os.path.join(vdir, "checkpoints",
                                               "last.ckpt"), fresh)
    assert_same_state(restored, state)
    assert set(m["metrics"]) >= {"val_loss", "valnarr_triplet"}

    # from_checkpoint serves the trained weights: the same embeddings as
    # the model in memory
    rng = np.random.default_rng(0)
    wave = rng.normal(scale=0.1, size=(1840,)).astype(np.float32)
    clip = rng.integers(0, 256, size=(23, 32, 32, 3)).astype(np.uint8)
    svc = EncoderService.from_checkpoint(vdir, device="cpu", batch_size=2)
    mem = EncoderService(state.model, trainer.config, device="cpu",
                         batch_size=2)
    np.testing.assert_array_equal(svc.embed_audio([wave]),
                                  mem.embed_audio([wave]))
    np.testing.assert_array_equal(svc.embed_video([clip]),
                                  mem.embed_video([clip]))
    # the override serves int8: the trained weights rebuilt with the flag
    svc8 = EncoderService.from_checkpoint(vdir, device="cpu", batch_size=2,
                                          quantize_int8=True)
    assert svc8.config.tpu.quantize_int8 is True
    cfg8 = Config.from_dict(trainer.config.to_dict())
    cfg8.tpu.quantize_int8 = True
    built = PeppaPig(cfg8)
    built.load_state_dict(state.model.state_dict())
    mem8 = EncoderService(built, cfg8, device="cpu", batch_size=2)
    a8 = svc8.embed_audio([wave])
    np.testing.assert_array_equal(a8, mem8.embed_audio([wave]))
    assert not np.array_equal(a8, mem.embed_audio([wave]))
    assert float((a8 * mem.embed_audio([wave])).sum()) > 0.99
    # the next run in the same log dir gets version_1
    trainer2 = L.Trainer(tiny_config(), log_dir=str(tmp_path / "logs"),
                         device="cpu")
    assert os.path.basename(trainer2.version_dir) == "version_1"


RESUME_KW = dict(num_sanity_val_steps=0, limit_train_batches=3,
                 limit_val_batches=1, max_epochs=2, accumulate_grad_batches=2)


@pytest.fixture(scope="module")
def straight_run(tmp_path_factory):
    """2 epochs of 3 micro-steps, k=2, with no interruption: the losses by
    step and the final state."""
    tmp = tmp_path_factory.mktemp("straight")
    before = torch.get_num_threads()
    torch.set_num_threads(2)  # module-scoped: set up before _two_threads
    try:
        trainer, state = fit(tmp, "logs", **RESUME_KW)
    finally:
        torch.set_num_threads(before)
    for p in tmp.rglob("*.ckpt*"):
        if p.is_file():
            p.unlink()
    return losses(trainer.version_dir), state


class PreemptedAtStep5(SyntheticPigData):
    """Sends SIGUSR1 while the loop takes micro-step 5's batch."""

    def train_batches(self, epoch=0):
        for i, b in enumerate(super().train_batches(epoch)):
            if epoch == 1 and i == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            yield b


@pytest.mark.parametrize("stop,stopped_at", [("epoch", 3), ("max_steps", 4),
                                             ("preempt", 5)])
def test_resume_is_bit_identical(tmp_path, straight_run, stop, stopped_at):
    """A run stopped at an epoch end (max_epochs), inside an epoch at an
    accumulation boundary (max_steps) or inside an accumulation group (a
    preemption signal) records the last complete epoch and the micro-steps
    trained of the next; resuming skips exactly those batches of the
    (seed, epoch) stream: the later losses and the final state equal the
    uninterrupted run's, bit for bit."""
    want, s_state = straight_run
    name = "last.ckpt"
    if stop == "epoch":
        partial, _ = fit(tmp_path, "partial", **{**RESUME_KW,
                                                 "max_epochs": 1})
    elif stop == "max_steps":
        partial, _ = fit(tmp_path, "partial", max_steps=2, **RESUME_KW)
    else:
        cfg = tiny_config(**RESUME_KW)
        cfg.tpu.prefetch = 0  # batches made in step with the loop
        partial = L.Trainer(cfg, log_dir=str(tmp_path / "partial"),
                            device="cpu")
        partial.fit(PreemptedAtStep5(cfg, n_train=12, n_val=8))
        assert partial.preempted
        name = "preempted.ckpt"
    m = meta(partial.version_dir, name)
    assert m["epoch"] == 0  # the last complete epoch
    assert m["epoch_batch_offset"] == stopped_at - 3
    resumed, r_state = fit(tmp_path, "resumed", resume_from=os.path.join(
        partial.version_dir, "checkpoints", name), **RESUME_KW)
    got = losses(resumed.version_dir)
    assert sorted(got) == list(range(stopped_at + 1, 7))
    for step in got:
        assert got[step] == want[step], step
    assert_same_state(r_state, s_state)


@pytest.mark.parametrize("log_every,poison_at", [(1, 1), (100, 2)])
def test_nonfinite_loss_watchdog(tmp_path, monkeypatch, log_every,
                                 poison_at):
    """A NaN loss stops the run with an emergency checkpoint, on a logging
    step and (checked one step late) off one."""
    real = L.train_step
    calls = {"n": 0}

    def poisoned(state, batch, seed, device=None):
        state, metrics = real(state, batch, seed, device)
        calls["n"] += 1
        if calls["n"] == poison_at:
            metrics = {"train_loss": torch.tensor(float("nan"))}
        return state, metrics

    monkeypatch.setattr(L, "train_step", poisoned)
    cfg = tiny_config(log_every_n_steps=log_every, limit_train_batches=3,
                      num_sanity_val_steps=0)
    trainer = L.Trainer(cfg, log_dir=str(tmp_path / "logs"), device="cpu")
    with pytest.raises(L.NonFiniteLossError, match=f"step {poison_at}"):
        trainer.fit(SyntheticPigData(cfg, n_train=16, n_val=8))
    path = os.path.join(trainer.version_dir, "checkpoints",
                        "emergency-nonfinite.ckpt")
    assert os.path.exists(path)
    assert "non-finite" in meta(trainer.version_dir,
                                "emergency-nonfinite.ckpt")["reason"]


def test_val_check_interval_steps(tmp_path):
    """val_check_interval=N validates every N micro-steps instead of at the
    epoch end, and validates the final state."""
    trainer, _ = fit(tmp_path, "logs", n_train=20, num_sanity_val_steps=0,
                     limit_train_batches=5, limit_val_batches=1,
                     val_check_interval=2)
    val_steps = [int(r["step"]) for r in rows(trainer.version_dir)
                 if r.get("val_loss")]
    assert val_steps == [2, 4, 5]
    assert meta(trainer.version_dir)["epoch"] == 0


def test_resume_restores_monitor_bests(tmp_path):
    m = CheckpointManager(str(tmp_path / "v0"))
    m.restore_monitor_state([
        {"monitor": "valnarr_rec_fixed", "mode": "max",
         "best_model_score": 0.76, "best_model_path": "old/epoch=14.ckpt"},
        {"monitor": "valnarr_triplet", "mode": "max",
         "best_model_score": 0.94, "best_model_path": "old/epoch=14t.ckpt"},
    ])
    rec, tri = m.monitors
    assert rec.best_score == 0.76 and tri.best_score == 0.94
    assert rec.decide({"valnarr_rec_fixed": 0.61}, epoch=77) is None
    assert tri.decide({"valnarr_triplet": 0.61}, epoch=77) is None
    decision = rec.decide({"valnarr_rec_fixed": 0.80}, epoch=80)
    assert decision is not None
    path, removals = decision
    assert "epoch=80" in path and removals == []
    m2 = CheckpointManager(str(tmp_path / "v1"))
    m2.restore_monitor_state(m.monitor_state())
    assert m2.monitors[0].best_score == 0.80
    assert m2.monitors[1].best_score == 0.94


def test_mid_epoch_break_records_last_full_epoch(tmp_path):
    kw = dict(num_sanity_val_steps=0, limit_val_batches=1,
              accumulate_grad_batches=1)
    # per-epoch validation, stopped after micro-step 2 of 4
    tr, _ = fit(tmp_path, "a", n_train=16, limit_train_batches=4,
                max_steps=2, **kw)
    assert meta(tr.version_dir)["epoch"] == -1
    # the trailing validation of val_check_interval, final epoch partial
    tr, _ = fit(tmp_path, "b", n_train=16, limit_train_batches=4,
                max_steps=3, val_check_interval=2, **kw)
    assert meta(tr.version_dir)["epoch"] == -1
    # a completed final epoch records epoch 0
    tr, _ = fit(tmp_path, "c", n_train=8, limit_train_batches=2, **kw)
    assert meta(tr.version_dir)["epoch"] == 0


def test_resume_from_best_monitor_ckpt_restores_all_bests(tmp_path):
    ckdir = tmp_path / "v0" / "checkpoints"
    ckdir.mkdir(parents=True)
    rec_meta = {"monitor": "valnarr_rec_fixed", "mode": "max",
                "best_model_score": 0.76, "epoch": 14}
    tri_meta = {"monitor": "valnarr_triplet", "mode": "max",
                "best_model_score": 0.94, "epoch": 12}
    last_meta = {"monitor": None, "best_model_score": None, "epoch": 14,
                 "monitors": [rec_meta, tri_meta]}
    for name, m in [("epoch=14-valnarr_rec_fixed=0.76.ckpt", rec_meta),
                    ("epoch=12-valnarr_triplet=0.94.ckpt", tri_meta),
                    ("last.ckpt", last_meta)]:
        (ckdir / name).write_bytes(b"")
        (ckdir / (name + ".json")).write_text(json.dumps(m))
    resume_from = str(ckdir / "epoch=14-valnarr_rec_fixed=0.76.ckpt")
    metas = CheckpointManager.resume_monitors_meta(resume_from, rec_meta)
    m = CheckpointManager(str(tmp_path / "v1"))
    m.restore_monitor_state(metas)
    assert m.monitors[0].best_score == 0.76
    assert m.monitors[1].best_score == 0.94
    assert m.monitors[0].decide({"valnarr_rec_fixed": 0.61}, epoch=15) is None
    assert m.monitors[1].decide({"valnarr_triplet": 0.61}, epoch=15) is None
    assert CheckpointManager.resume_monitors_meta(
        str(ckdir / "last.ckpt"), last_meta) == [rec_meta, tri_meta]
    assert CheckpointManager.resume_monitors_meta(
        str(ckdir / "x.ckpt"), {}) == []


def test_resumed_fit_keeps_both_bests(tmp_path):
    """A fit resumed from either best file starts with both monitors'
    bests, so its first validation cannot demote them."""
    first, _ = fit(tmp_path, "a", num_sanity_val_steps=0)
    ckdir = os.path.join(first.version_dir, "checkpoints")
    bests = sorted(c for c in os.listdir(ckdir)
                   if c.startswith("epoch=") and c.endswith(".ckpt"))
    scores = {m["monitor"]: m["best_model_score"]
              for m in meta(first.version_dir)["monitors"]}
    for i, name in enumerate(bests):
        cfg = tiny_config(num_sanity_val_steps=0, max_epochs=1)
        tr = L.Trainer(cfg, log_dir=str(tmp_path / f"r{i}"), device="cpu")
        tr.fit(SyntheticPigData(cfg, n_train=12, n_val=8),
               resume_from=os.path.join(ckdir, name))
        # epoch 0 was complete: nothing left to train, nothing validated
        assert {m.monitor: m.best_score for m in tr._ckpt.monitors} == scores


def test_preemption_guard_and_collapse_detector_match_jax():
    prev = signal.getsignal(signal.SIGUSR1)
    with PreemptionGuard(("SIGUSR1", "SIGNOSUCH")) as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.triggered and guard.signame == "SIGUSR1"
    assert signal.getsignal(signal.SIGUSR1) is prev
    # one loss stream: it learns, then pins at the saddle 2*0.2*(1-1/8)
    rng = np.random.default_rng(0)
    stream = list(0.35 + 0.01 * rng.normal(size=20)) + [0.1] * 5 \
        + [0.35 + 1e-6 * rng.normal() for _ in range(40)]
    fired = []
    for det in (JaxCollapse(0.2, 8, window=25),
                CollapseDetector(0.2, 8, window=25)):
        fired.append(next(i for i, x in enumerate(stream) if det.update(x)))
    assert fired[0] == fired[1] == 25 + 24
    with pytest.raises(ValueError):
        CollapseDetector(0.2, 1)


def test_metrics_csv_matches_the_jax_logger(tmp_path):
    calls = [({"train_loss": 0.5, "lr": 0.0}, 1, 0),
             ({"train_loss": 0.4, "lr": 1e-5, "perf/items_per_sec": 3.0},
              2, 0),
             ({"val_loss": 0.3, "valnarr_triplet": 0.5}, 2, 0)]
    out = {}
    for tag, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        logger = cls(str(tmp_path / tag))
        for metrics, step, epoch in calls:
            logger.log(metrics, step=step, epoch=epoch)
        logger.close()
        out[tag] = [{k: v for k, v in r.items() if k != "time"}
                    for r in rows(str(tmp_path / tag))]
        with open(tmp_path / tag / "metrics.csv") as f:
            out[tag + "_header"] = f.readline()
    assert out["port"] == out["jax"]
    assert out["port_header"] == out["jax_header"]
    # resume into the same directory extends the file under its header
    logger = MetricsLogger(str(tmp_path / "port"))
    logger.log({"train_loss": 0.2}, step=3, epoch=1)
    logger.close()
    assert [r["step"] for r in rows(str(tmp_path / "port"))] == \
        ["1", "2", "2", "3"]


def test_step_timer_counts_the_items_of_its_window(monkeypatch):
    """Items/s counts the items of the steps inside the timed window only:
    the clock starts at the end of step warmup + 1, so that step's items
    lie outside it."""
    import types

    from peppa_tpu_torch.utils import profiling

    clock = iter([0.0, 1.0, 2.0, 3.0, 5.0, 7.0])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    timer = profiling.StepTimer(warmup_steps=2)
    for items in (100, 100, 8, 8, 8, 8):
        timer.step(items=items)
    # the window runs from 2.0 to 7.0 and holds the last three steps
    assert timer.steps_per_sec == pytest.approx(3 / 5.0, rel=1e-12)
    assert timer.items_per_sec == pytest.approx(24 / 5.0, rel=1e-12)
