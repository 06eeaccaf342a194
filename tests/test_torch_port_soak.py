"""The soak path on the CPU: `peppa_tpu_torch.soak_report` against
scripts/soak_report.py on the same run directories, `peppa_tpu_torch.
soak_run`'s attempts, and the two soak recipes in both packages.

Both reports must give the same exit code and print the same lines.  The
one number they may print differently is the lr check's max error: each
script evaluates the schedule in its package's arithmetic (float32 in the
JAX package, Python floats in the port), so that number is masked before
the lines are compared.  The run directories are
tests/test_soak_report.py's, plus a two-run resume chain whose superseded
rows would fail the lr check if they were kept.
"""

import csv
import json
import os
import re
import sys

import pytest
import yaml

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu_torch import soak_report, soak_run
from peppa_tpu_torch.config import Config
from test_soak_report import _write_run, soak_report as jax_soak_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ("hparams_soak.yaml", "hparams_soak_production.yaml")


def _lr_linear(opt_step):
    x = opt_step / 100
    f = x / 0.1 if x < 0.1 else max((x - 1.0) / (0.1 - 1.0), 0.0)
    return 1e-4 * f


def _reports(capsys, *run_dirs):
    """(exit code, printed lines) of each script over `run_dirs`."""
    out = []
    for script in (jax_soak_report, soak_report):
        rc = script.main([str(d) for d in run_dirs])
        text = re.sub(r"max err [0-9.e+-]+", "max err <e>",
                      capsys.readouterr().out)
        out.append((rc, text.splitlines()))
    return out


def _chain(tmp_path):
    """version_0 logs micro-steps 0-7 (a validation row at 6) and
    version_1, resumed at micro-step 7, logs 7-13 (a validation row at
    13): version_0's row 7 is superseded, and it carries a wrong lr."""
    v0 = _write_run(tmp_path, t_total=100, lr_fn=_lr_linear, train_rows=6,
                    name="version_0")
    with open(v0 / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    bad = dict(rows[0], step=7, time=107.0, lr=5e-5)
    with open(v0 / "metrics.csv", "a", newline="") as f:
        csv.DictWriter(f, fieldnames=list(rows[0])).writerow(bad)
    v1 = tmp_path / "version_1"
    (v1 / "checkpoints").mkdir(parents=True)
    (v1 / "hparams.yaml").write_text((v0 / "hparams.yaml").read_text())
    cols = list(rows[0])
    with open(v1 / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for i in range(7, 13):
            w.writerow({"step": i, "epoch": 0, "time": 200.0 + i,
                        "train_loss": 0.4 - 0.01 * i,
                        "lr": _lr_linear(i // 2), "perf/items_per_sec": 60.0,
                        "valnarr_rec_fixed": "", "valnarr_triplet": ""})
        w.writerow({"step": 13, "epoch": 0, "time": 213.0, "train_loss": "",
                    "lr": "", "perf/items_per_sec": "",
                    "valnarr_rec_fixed": 0.75, "valnarr_triplet": 0.85})
    # the resumed run beat one monitor and not the other
    p = v1 / "checkpoints" / "epoch=0-valnarr_rec_fixed.ckpt"
    p.write_bytes(b"")
    (v1 / "checkpoints" / (p.name + ".json")).write_text(json.dumps(
        {"monitor": "valnarr_rec_fixed", "mode": "max",
         "best_model_score": 0.75, "epoch": 0}))
    (v1 / "checkpoints" / "last.ckpt").write_bytes(b"")
    return v0, v1


@pytest.mark.parametrize("case", ["constant_lr", "warmup_linear",
                                  "wrong_lr", "no_train_rows",
                                  "null_best_score", "chain",
                                  "chain_last_run_alone"])
def test_soak_report_matches_the_jax_script(tmp_path, capsys, case):
    want_rc = 0
    if case == "constant_lr":
        dirs = [_write_run(tmp_path, t_total=-1, lr_fn=lambda s: 1e-4)]
    elif case == "warmup_linear":
        dirs = [_write_run(tmp_path, t_total=100, lr_fn=_lr_linear)]
    elif case == "wrong_lr":
        dirs = [_write_run(tmp_path, t_total=100, lr_fn=lambda s: 1e-4)]
        want_rc = 1
    elif case == "no_train_rows":
        dirs = [_write_run(tmp_path, t_total=-1, lr_fn=lambda s: 1e-4,
                           train_rows=0, with_ckpts=False)]
        want_rc = 1
    elif case == "null_best_score":
        rd = _write_run(tmp_path, t_total=-1, lr_fn=lambda s: 1e-4)
        (rd / "checkpoints" / "epoch=0-valnarr_rec_fixed.ckpt.json"
         ).write_text(json.dumps({"monitor": "valnarr_rec_fixed",
                                  "mode": "max", "best_model_score": None,
                                  "epoch": 0}))
        dirs = [rd]
        want_rc = 1
    elif case == "chain":
        dirs = list(_chain(tmp_path))
    else:  # version_0 alone keeps its wrong row 7
        dirs = [_chain(tmp_path)[0]]
        want_rc = 1
    (jax_rc, jax_lines), (rc, lines) = _reports(capsys, *dirs)
    assert rc == jax_rc == want_rc
    assert lines == jax_lines
    assert any(line.startswith("- [") for line in lines) \
        or case == "no_train_rows"
    if case == "chain":
        assert "- micro-steps logged: 0..13 (optimizer steps ≈ 6, " \
               "accum=2)" in lines
        assert any("across 2 resume-chain runs" in line for line in lines)
        # one monitor's best file in each run's directory
        assert any("best_model_score 0.7500 == max(metrics.csv)=0.7500"
                   in line for line in lines)
        assert any("best_model_score 0.9000 == max(metrics.csv)=0.9000"
                   in line for line in lines)


class _Stub:
    """A training command that exits with the codes it is given in turn and
    writes version_0's last.ckpt on its first attempt."""

    def __init__(self, tmp_path, codes):
        self.state = tmp_path / "attempts"
        self.script = tmp_path / "stub.py"
        self.script.write_text(
            "import os, sys\n"
            f"state, codes = {str(self.state)!r}, {list(codes)!r}\n"
            "n = int(open(state).read()) if os.path.exists(state) else 0\n"
            "open(state, 'w').write(str(n + 1))\n"
            "log_dir = sys.argv[sys.argv.index('--log_dir') + 1]\n"
            "if n == 0 and codes[0] == 75:\n"
            "    ckpt = os.path.join(log_dir, 'version_0', 'checkpoints')\n"
            "    os.makedirs(ckpt, exist_ok=True)\n"
            "    open(os.path.join(ckpt, 'last.ckpt'), 'w').close()\n"
            "sys.exit(codes[n])\n")
        self.command = [sys.executable, str(self.script)]


def test_soak_run_preemption_then_crash_then_done(tmp_path, capsys):
    stub = _Stub(tmp_path, [75, 1, 0])
    log_dir = str(tmp_path / "logs")
    slept = []
    rc, attempts = soak_run.soak("cfg.yaml", log_dir, ["--synthetic_data"],
                                 command=stub.command, sleep=slept.append)
    base = [*stub.command, "--config_file", "cfg.yaml", "--log_dir", log_dir]
    last = os.path.join(log_dir, "version_0", "checkpoints", "last.ckpt")
    assert rc == 0
    assert attempts == [
        (base + ["--synthetic_data"], 75),
        (base + ["--auto_resume", "--synthetic_data"], 1),
        (base + ["--resume_from", last, "--synthetic_data"], 0)]
    assert slept == [30.0]  # the pause after the crash, and only there
    out = capsys.readouterr().out
    assert "=== soak_run attempt 2: --auto_resume ===" in out
    assert f"=== soak_run: rc=1, resuming from {last} ===" in out
    assert "=== soak_run: completed on attempt 3 ===" in out


def test_soak_run_crash_without_checkpoint_retries_fresh_and_gives_up(
        tmp_path, capsys, monkeypatch):
    stub = _Stub(tmp_path, [3, 3, 3])
    monkeypatch.setenv("MAX_ATTEMPTS", "2")
    slept = []
    rc, attempts = soak_run.soak("cfg.yaml", str(tmp_path / "logs"),
                                 command=stub.command, pause=0.5,
                                 sleep=slept.append)
    assert rc == 1 and [a[1] for a in attempts] == [3, 3]
    assert attempts[0][0] == attempts[1][0]  # both fresh
    assert slept == [0.5, 0.5]
    out = capsys.readouterr().out
    assert "retrying fresh" in out
    assert "=== soak_run: giving up after 2 attempts ===" in out


@pytest.mark.parametrize("recipe", RECIPES)
def test_soak_recipes_load_alike_in_both_packages(recipe):
    """Both recipes give the same values in both packages; the port
    ignores `host_rss_recycle_gb` and hands `bn_dtype` to every BatchNorm
    of the video tower."""
    import torch

    from peppa_tpu_torch.models.dual_encoder import PeppaPig
    from peppa_tpu_torch.models.layers import BatchNorm

    path = os.path.join(ROOT, "scripts", recipe)
    port, jax_cfg = Config.load(path), JaxConfig.load(path)
    assert port.to_dict() == jax_cfg.to_dict()
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert port.tpu.host_rss_recycle_gb == raw["tpu"]["host_rss_recycle_gb"]
    trainer = raw["training"]["trainer_args"]
    assert (port.training.accumulate_grad_batches, port.training.precision
            ) == (trainer["accumulate_grad_batches"], trainer["precision"])
    port.audio.pretrained = False  # no wav2vec2 file in the repository
    bns = [m for m in PeppaPig(port).modules() if isinstance(m, BatchNorm)]
    assert len(bns) > 30
    assert {m.dtype for m in bns} == {torch.bfloat16}
