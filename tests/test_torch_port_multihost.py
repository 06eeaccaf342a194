"""The port's multi-process training coherence, case for case after
tests/test_multihost.py and tests/test_distributed_preempt.py: the input
interleave against the JAX package's, the main-process write gating (by a
monkeypatched `peppa_tpu_torch.utils.dist`, as the JAX tests simulate a
topology), and a real two-rank `Trainer.fit` in two gloo processes
(tests/torch_port_dist_worker.py, job "multihost", started once for the
module): against one process on the concatenated batches, with only rank 0
writing, both ranks stopping at the same micro-step under `max_time` and
under a signal to one rank, the run resumed inside an accumulation group
landing on the straight run's state (to rounding: the checkpoint holds
the ranks' summed buffer, which resumes on any number of ranks); and the
trainer's CLI under `torchrun` with two gloo ranks.

Sizes: the fits' configuration of tests/torch_port_dist_worker.py
(32x32 frames, 1600 Hz, the conv-only audio trunk, mc3_18, float32,
micro-batches of 2 clips a rank, k = 2, two epochs of 16 synthetic
clips).  Two ranks against one process on the same global batches: the
losses within rel 1e-5 on the initial weights (micro-steps 1-4) and 1e-3
after the parameters moved (Adam's first updates are about lr * 3.2 *
sign(g), so rounding flips the sign of gradients near 0:
tests/test_torch_port_train_step.py's tolerance); the final parameters'
updates from the seeded init, after three optimizer steps that move them
through the chaotic float32 video tower: the audio tower's within 10% of
each tensor's largest update entry, the video tower's by norm within 25%
(measured: 2.4% and 6.3%), each plus 0.01 lr for the attention pools'
output biases, whose gradients are rounding noise.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings, strategies as st

import torch_port_dist_worker as W
from peppa_tpu.data.datamodule import (multihost_interleave as
                                       jax_multihost_interleave)
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import (SyntheticPigData,
                                             multihost_interleave)
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.parallel.mesh import Mesh
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training.checkpoint import load_checkpoint
from peppa_tpu_torch.training.loop import Trainer
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.utils import dist

LR = Config().optimizer.lr


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------- interleave
def test_interleave_single_process_is_identity():
    entries = list(range(7))
    assert list(multihost_interleave(entries, lambda e: (), 0, 1)) == entries


@settings(max_examples=60, deadline=None)
@given(keys=st.lists(st.sampled_from("ABC"), max_size=40),
       count=st.integers(1, 4))
def test_interleave_matches_jax(keys, count):
    entries = [(k, i) for i, k in enumerate(keys)]
    key = lambda e: e[0]
    per_rank = [list(multihost_interleave(entries, key, r, count))
                for r in range(count)]
    for r in range(count):
        assert per_rank[r] == list(jax_multihost_interleave(entries, key, r,
                                                            count))
    # same steps, same shape at each step, disjoint entries
    assert len({len(p) for p in per_rank}) == 1
    for step in zip(*per_rank):
        assert len({e[0] for e in step}) == 1
    taken = [e for p in per_rank for e in p]
    assert len(taken) == len(set(taken))


def test_interleave_drops_the_ragged_tail():
    entries = [("A", i) for i in range(3)]
    out = [list(multihost_interleave(entries, lambda e: e[0], r, 2))
           for r in range(2)]
    assert out == [[("A", 0)], [("A", 1)]]


def test_native_plan_interleave_matches_jax():
    # plan entries as bucket_plan makes them: (items, (t, h, w, c, s))
    plan = [([1, 2], (8, 32, 32, 3, 1280)), ([3, 4], (20, 32, 32, 3, 3200)),
            ([5, 6], (8, 32, 32, 3, 1280)), ([7, 8], (8, 32, 32, 3, 1280))]
    key = lambda p: (len(p[0]),) + tuple(p[1])
    for r in range(2):
        got = list(multihost_interleave(plan, key, r, 2))
        assert got == list(jax_multihost_interleave(plan, key, r, 2))
    assert list(multihost_interleave(plan, key, 1, 2)) == [plan[2]]


def _cfg(tmp_path, **training):
    cfg = Config.from_dict(W.fit_raw(str(tmp_path / "data")))
    for k, v in training.items():
        setattr(cfg.training, k, v)
    return cfg


def _as_rank(monkeypatch, rank, count=2):
    monkeypatch.setattr(dist, "process_index", lambda: rank)
    monkeypatch.setattr(dist, "process_count", lambda: count)


def test_train_batches_multihost_slices(tmp_path, monkeypatch):
    """Two simulated ranks: the same steps and shapes, disjoint data, and
    together the one-process stream."""
    cfg = _cfg(tmp_path)
    data = SyntheticPigData(cfg, n_train=16, n_val=8)
    data.setup()
    whole = list(data.train_batches(epoch=0))
    streams = []
    for r in range(2):
        _as_rank(monkeypatch, r)
        streams.append(list(data.train_batches(epoch=0)))
    assert len(streams[0]) == len(streams[1]) == len(whole) // 2 > 0
    for t, (b0, b1) in enumerate(zip(*streams)):
        assert b0.video.shape == b1.video.shape
        assert not np.allclose(b0.audio, b1.audio)
        np.testing.assert_array_equal(b0.audio, whole[2 * t].audio)
        np.testing.assert_array_equal(b1.audio, whole[2 * t + 1].audio)


def _fit_simulated(tmp_path, monkeypatch, rank):
    _as_rank(monkeypatch, rank)
    cfg = _cfg(tmp_path, num_sanity_val_steps=0, limit_train_batches=2,
               limit_val_batches=1, max_epochs=1)
    log_dir = str(tmp_path / "logs")
    trainer = Trainer(cfg, log_dir=log_dir, device="cpu")
    state = trainer.fit(SyntheticPigData(cfg, n_train=16, n_val=8))
    assert state.step == 2
    return trainer, log_dir


def test_trainer_nonmain_process_writes_nothing(tmp_path, monkeypatch):
    """process_index 1 makes no version directory, metrics or checkpoint."""
    trainer, log_dir = _fit_simulated(tmp_path, monkeypatch, 1)
    assert trainer.version_dir == os.path.join(log_dir, "nonmain_process")
    assert not os.path.exists(log_dir) or not os.listdir(log_dir)


def test_trainer_main_process_still_writes(tmp_path, monkeypatch):
    trainer, _ = _fit_simulated(tmp_path, monkeypatch, 0)
    for name in ("hparams.yaml", "metrics.csv", "checkpoints/last.ckpt"):
        assert os.path.exists(os.path.join(trainer.version_dir, name)), name
    for p in (tmp_path / "logs").rglob("*.ckpt"):
        p.unlink()  # 0.25 GB each


# --------------------------------------------------------- two real ranks
@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The four two-rank fits, and meanwhile the one-process fit on the
    concatenated batches (micro-batches of 4 clips)."""
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("multihost")
    W.write_inputs({"dir": str(d), "data_dir": str(d / "data")}, str(d))
    procs = W.start_ranks("multihost", str(d))
    try:
        cfg = Config.from_dict(W.fit_raw(str(d / "data"),
                                         batch_size=2 * W.FIT_B))
        one = Trainer(cfg, log_dir=str(d / "one"), device="cpu")
        one.fit(SyntheticPigData(cfg, n_train=W.FIT_TRAIN, n_val=8))
    finally:
        ranks = W.finish_ranks("multihost", procs, str(d), timeout=900)
    yield {"dir": d, "ranks": ranks, "one": one.version_dir}
    for p in d.rglob("*.ckpt"):
        p.unlink()


def _losses(version_dir):
    with open(os.path.join(version_dir, "metrics.csv")) as f:
        return {int(r["step"]): float(r["train_loss"])
                for r in csv.DictReader(f) if r.get("train_loss")}


def _last(version_dir):
    return load_checkpoint(os.path.join(version_dir, "checkpoints",
                                        "last.ckpt"))[0]


def test_two_ranks_match_one_process_on_the_concatenated_batches(fits):
    straight = fits["ranks"][0]["straight"]
    steps = W.FIT_EPOCHS * W.FIT_TRAIN // (2 * W.FIT_B)
    assert straight["step"] == steps == 8
    got, want = _losses(straight["version_dir"]), _losses(fits["one"])
    assert sorted(got) == sorted(want) == list(range(1, steps + 1))
    # micro-steps 1-4 run on the initial weights (k = 2, and the first
    # optimizer step's learning rate is 0 under warmup_linear)
    np.testing.assert_allclose([got[s] for s in range(1, 5)],
                               [want[s] for s in range(1, 5)], rtol=1e-5)
    np.testing.assert_allclose([got[s] for s in range(5, steps + 1)],
                               [want[s] for s in range(5, steps + 1)],
                               rtol=1e-3)
    _hold_updates(_last(straight["version_dir"])["model"],
                  _last(fits["one"])["model"], fits["dir"])


def _hold_updates(got, want, fit_dir):
    """Two final states of the fits held against each other: each tensor's
    difference against its update from the seeded init (module doc)."""
    start = init_model(Config.from_dict(W.fit_raw(str(fit_dir))),
                       seed=0, device="cpu").state_dict()
    shares = {"audio": 0.0, "video": 0.0}
    for k, w in want.items():
        if not w.is_floating_point() or "running_" in k:
            continue  # the step counter; the statistics (chaotic, above)
        d, update = got[k] - w, w - start[k]
        if k.startswith("video_encoder."):
            bound = 0.25 * torch.linalg.norm(update) + 1e-2 * LR
            share = torch.linalg.norm(d) / bound
        else:
            share = d.abs().max() / (0.1 * update.abs().max() + 1e-2 * LR)
        assert share <= 1.0, k
        tower = "video" if k.startswith("video_encoder.") else "audio"
        shares[tower] = max(shares[tower], share.item())
    return shares


def test_only_rank_zero_writes(fits):
    for tag in ("straight", "max_time", "preempt", "resume"):
        assert sorted(os.listdir(fits["dir"] / tag)) == ["version_0"], tag
        assert fits["ranks"][0][tag]["version_dir"] == str(
            fits["dir"] / tag / "version_0")
        assert fits["ranks"][1][tag]["version_dir"] == str(
            fits["dir"] / tag / "nonmain_process")
    ckpts = sorted(os.listdir(fits["dir"] / "preempt" / "version_0"
                              / "checkpoints"))
    assert "preempted.ckpt" in ckpts, ckpts


def test_ranks_stop_together_at_rank_ones_max_time(fits):
    r0, r1 = (r["max_time"] for r in fits["ranks"])
    assert r0["step"] == r1["step"] == 2  # rank 1's clock ran out there
    assert r0["digest"] == r1["digest"]
    assert not r0["preempted"] and not r1["preempted"]


def test_ranks_stop_together_on_a_signal_to_rank_one(fits):
    r0, r1 = (r["preempt"] for r in fits["ranks"])
    assert r0["step"] == r1["step"] == 3  # inside an accumulation group
    assert r0["preempted"] and r1["preempted"]
    path = os.path.join(r0["version_dir"], "checkpoints", "preempted.ckpt")
    payload, meta = load_checkpoint(path)
    assert (payload["step"], meta["epoch"], meta["epoch_batch_offset"]) \
        == (3, -1, 3)
    # the buffer is the global one, the SUM of the ranks' own
    acc0, acc1 = r0["acc_grads"], r1["acc_grads"]
    assert sorted(payload["acc_grads"]) == sorted(acc0) == sorted(acc1)
    assert any(not torch.equal(acc0[n], acc1[n]) for n in acc0)
    for n, t in payload["acc_grads"].items():
        assert torch.equal(t, acc0[n] + acc1[n]), n


def test_resumed_run_lands_on_the_straight_runs_state(fits):
    """Resumed on two ranks from preempted.ckpt (micro-step 3, inside an
    accumulation group, whose buffer is the global one and each rank takes
    half of): the ranks alike bit for bit; micro-step 4's loss the
    straight run's bit for bit (the same parameters); the mean handed to
    BertAdam at micro-step 4 within 1e-5 of each tensor's largest entry
    (the buffer is folded in another order: rounding; measured 6.3e-7);
    the final state at the tolerances of the two-rank fit against one
    process (module doc; measured 3.1% and 10.5% of them)."""
    for r in fits["ranks"]:
        assert not r["resume"]["preempted"]
        assert r["resume"]["step"] == r["straight"]["step"]
    r0, r1 = (r["resume"] for r in fits["ranks"])
    assert r0["digest"] == r1["digest"]
    straight = fits["ranks"][0]["straight"]
    got, want = _losses(r0["version_dir"]), _losses(straight["version_dir"])
    assert sorted(got) == list(range(4, 9))
    assert got[4] == want[4]
    # optimizer steps at micro-steps 2, 4, 6, 8; the resume's first is 4
    assert len(straight["handed"]) == 4 and len(r0["handed"]) == 3
    for n, w in straight["handed"][1].items():
        d = (r0["handed"][0][n] - w).abs().max()
        assert d <= 1e-5 * w.abs().max() + 1e-12, n
    final = _last(r0["version_dir"])
    assert final["step"] == 8
    _hold_updates(final["model"], _last(straight["version_dir"])["model"],
                  fits["dir"])


def test_a_mid_group_checkpoint_resumes_on_any_number_of_ranks(fits):
    """preempted.ckpt, taken inside a group on two ranks, holds the global
    buffer: a rank of W takes 1/W of it (the rest of the state as is)."""
    path = os.path.join(fits["ranks"][0]["preempt"]["version_dir"],
                        "checkpoints", "preempted.ckpt")
    payload = load_checkpoint(path)[0]
    cfg = Config.from_dict(W.fit_raw(str(fits["dir"])))
    for w in (1, 2, 4):
        mesh = Mesh((w, 1), ("data", "model"), rank=w - 1)
        state = TrainState.create(init_model(cfg, seed=1, device="cpu"),
                                  cfg, mesh)
        state.load_state_dict(payload)
        assert state.step == 3
        assert W.state_digest(state.model.state_dict()) \
            == W.state_digest(payload["model"])
        for n, acc in payload["acc_grads"].items():
            assert torch.equal(state.acc_grads[n], acc / w), (w, n)


def test_checkpoint_loads_into_a_single_process_service(fits):
    vdir = fits["ranks"][0]["straight"]["version_dir"]
    svc = EncoderService.from_checkpoint(vdir, device="cpu")
    best = [p for p in os.listdir(os.path.join(vdir, "checkpoints"))
            if p.startswith("epoch=") and p.endswith(".ckpt")]
    payloads = [load_checkpoint(os.path.join(vdir, "checkpoints", p))[0]
                for p in best]
    served = svc.model.state_dict()
    assert any(all(torch.equal(served[k], v) for k, v in p["model"].items())
               for p in payloads)


def test_torchrun_launches_the_trainer_cli(tmp_path):
    """`torchrun --nproc_per_node=2 -m peppa_tpu_torch.run --device cpu`:
    two gloo ranks, one run directory, both ranks exit 0."""
    raw = W.fit_raw(str(tmp_path / "data"))
    raw["training"].update(max_epochs=1, limit_train_batches=2,
                           limit_val_batches=1, num_sanity_val_steps=0)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(yaml.safe_dump(raw))
    log_dir = tmp_path / "logs"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr", "127.0.0.1", "--master_port", str(W.free_port()),
         "-m", "peppa_tpu_torch.run", "--device", "cpu", "--synthetic_data",
         "--synthetic_train", "16", "--synthetic_val", "8", "--config_file",
         str(cfg_file), "--log_dir", str(log_dir)],
        cwd=W.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert sorted(os.listdir(log_dir)) == ["version_0"]
    with open(log_dir / "version_0" / "metrics.csv") as f:
        steps = [r["step"] for r in csv.DictReader(f) if r.get("train_loss")]
    assert steps == ["1", "2"]
    assert (log_dir / "version_0" / "checkpoints" / "last.ckpt").exists()
    for p in log_dir.rglob("*.ckpt"):
        p.unlink()


def test_corpus_preparation_is_refused_over_two_ranks(fits):
    for r in fits["ranks"]:
        assert "prepare_data() in one process" in r["prepare_refused"]
