"""The port's training entry points on the CPU: the CLI
(`python -m peppa_tpu_torch.run`) end to end, through a preemption signal
and an auto-resume, and one `fit` against the JAX package's `Trainer` on
carried-across weights.

The JAX-vs-port `fit` (`audio.dropout: 0.0`, so no dropout and no
layer-drop, k=2, 2 optimizer steps under `warmup_linear`) holds the logged
`train_loss` rows and the validation's loss keys within rtol 1e-4: the
second optimizer step moves the weights by the scheduled learning rate, and
the port's float32 arithmetic differs from XLA's in the last bits.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import yaml

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.datamodule import SyntheticPigData as JaxPigData
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.training.loop import Trainer as JaxTrainer
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import SyntheticPigData
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.training.checkpoint import find_preempted_checkpoint
from peppa_tpu_torch.training.loop import Trainer, parse_max_time

from test_torch_port_trainer import (RAW, _drop_checkpoints,  # noqa: F401
                                     _init_once, _two_threads, rows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_file(tmp_path, **training) -> str:
    cfg = Config.from_dict(RAW)
    cfg.training.num_sanity_val_steps = 0
    cfg.training.limit_val_batches = 1
    for k, v in training.items():
        setattr(cfg.training, k, v)
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return str(path)


def _cli(config_file, log_dir, *extra):
    return [sys.executable, "-m", "peppa_tpu_torch.run", "--synthetic_data",
            "--device", "cpu", "--config_file", config_file, "--log_dir",
            log_dir, "--synthetic_train", "16", "--synthetic_val", "8",
            *extra]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # as _two_threads does in this process
    return env


def test_cli_writes_a_run_both_packages_read(tmp_path):
    config_file = _config_file(tmp_path)
    log_dir = str(tmp_path / "logs")
    out = subprocess.run(_cli(config_file, log_dir, "--max_epochs", "1",
                              "--seed", "3"),
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    vdir = os.path.join(log_dir, "version_0")
    assert os.path.exists(os.path.join(vdir, "checkpoints", "last.ckpt"))
    hparams = os.path.join(vdir, "hparams.yaml")
    want = Config.load(config_file)
    want.training.max_epochs, want.training.seed = 1, 3
    want.data.prepare = want.data.extract = False
    port, jax_cfg = Config.load(hparams), JaxConfig.load(hparams)
    assert port.to_dict() == jax_cfg.to_dict()
    assert port.git_commit  # stamped from the checkout
    port.git_commit = None
    assert port.to_dict() == want.to_dict()
    assert isinstance(jax_cfg.optimizer.e, float)  # 1e-06, not a string

    # without --synthetic_data it trains on the episode tree of
    # data.data_dir, and there is none
    cfg = Config.load(config_file)
    cfg.data.data_dir = str(tmp_path / "no_tree")
    with open(config_file, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    out = subprocess.run([sys.executable, "-m", "peppa_tpu_torch.run",
                          "--device", "cpu", "--config_file", config_file,
                          "--log_dir", log_dir], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "Extract the data first" in out.stderr


def test_cli_preempted_by_sigusr1_exits_75_then_auto_resumes(tmp_path,
                                                             capsys):
    config_file = _config_file(tmp_path, max_epochs=2,
                               limit_train_batches=2,
                               accumulate_grad_batches=1)
    log_dir = str(tmp_path / "logs")
    version_0 = os.path.join(log_dir, "version_0")
    proc = subprocess.Popen(_cli(config_file, log_dir), cwd=ROOT,
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        # stopped once it has logged a row: the two runs are a resume
        # chain of rows for both soak reports (below)
        while not (os.path.exists(os.path.join(version_0, "metrics.csv"))
                   and rows(version_0)) \
                and proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()[-3000:]
        proc.send_signal(signal.SIGUSR1)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 75, err[-3000:]
    ckpt = os.path.join(log_dir, "version_0", "checkpoints",
                        "preempted.ckpt")
    with open(ckpt + ".json") as f:
        assert "preempted by SIGUSR1" in json.load(f)["reason"]
    config = Config.load(config_file)
    config.data.prepare = config.data.extract = False
    assert find_preempted_checkpoint(config, log_dir) == ckpt
    other = Config.load(config_file)
    other.training.seed = 9
    assert find_preempted_checkpoint(other, log_dir) is None

    out = subprocess.run(_cli(config_file, log_dir, "--auto_resume"),
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "auto-resume: continuing from" in out.stderr
    assert not os.path.exists(ckpt) and os.path.exists(ckpt + ".consumed")
    steps = [int(r["step"]) for r in rows(os.path.join(log_dir, "version_1"))
             if r.get("train_loss")]
    assert steps[-1] == 4  # 2 epochs of 2 micro-steps in all

    # the chain passes the port's soak report and the JAX package's, with
    # the same lines (the lr error masked: tests/test_torch_port_soak.py)
    from peppa_tpu_torch import soak_report
    from test_torch_port_soak import _reports

    chain = [os.path.join(log_dir, f"version_{i}") for i in (0, 1)]
    (jax_rc, jax_lines), (rc, lines) = _reports(capsys, *chain)
    assert (rc, jax_rc) == (0, 0), lines
    assert lines == jax_lines
    assert soak_report.main(chain[1:]) == 0  # the resumed run alone


def test_parse_max_time_and_default_device(monkeypatch):
    assert parse_max_time("02:00:00:00") == 2 * 24 * 3600
    assert parse_max_time("1:30") == 90
    assert parse_max_time(None) is None
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config.from_dict(RAW), log_dir="unused")


def test_fit_matches_jax_trainer(tmp_path):
    """The same carried-across weights, the same synthetic stream: the
    port's logged train losses and validation losses agree with the JAX
    trainer's within rtol 1e-4 (module doc), under the same columns."""
    raw = json.loads(json.dumps(RAW))
    raw["audio"]["dropout"] = 0.0
    raw["training"].update(num_sanity_val_steps=0, limit_train_batches=4,
                           limit_val_batches=1)
    jax_cfg, cfg = JaxConfig.from_dict(raw), Config.from_dict(raw)
    assert cfg.to_dict() == jax_cfg.to_dict()
    jax_tr = JaxTrainer(jax_cfg, log_dir=str(tmp_path / "jax"))
    jax_tr.fit(JaxPigData(jax_cfg, n_train=16, n_val=8))
    _, variables = jax_init_model(jax_cfg,
                                  jax.random.PRNGKey(jax_cfg.training.seed))
    variables = jax.tree.map(np.asarray, variables)
    tr = Trainer(cfg, log_dir=str(tmp_path / "port"), device="cpu")
    state = tr.fit(SyntheticPigData(cfg, n_train=16, n_val=8),
                   pretrained_loader=lambda m: load_jax_variables(
                       m, variables))
    assert state.step == 4 and state.optimizer.param_groups[0]["step"] == 2
    with open(os.path.join(jax_tr.version_dir, "metrics.csv")) as f:
        jax_header = f.readline()
    with open(os.path.join(tr.version_dir, "metrics.csv")) as f:
        assert f.readline() == jax_header
    want, got = rows(jax_tr.version_dir), rows(tr.version_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for w, g in zip(want, got):
        for k in ("train_loss", "val_loss", "valnarr_loss"):
            if w[k]:
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=1e-4, err_msg=(k, w["step"]))
        if w["lr"]:
            np.testing.assert_allclose(float(g["lr"]), float(w["lr"]),
                                       rtol=1e-6)
    assert float(got[1]["lr"]) > 0  # the second optimizer step moves them
