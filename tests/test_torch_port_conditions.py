"""The paper's seven ablation conditions in the port (`config.py`:
`conditions`, `dump_conditions`, `_comparable`, `match_conditions`,
`save_conditions`) against the JAX package's, and the port's sweep
(`peppa_tpu_torch/ablation_sweep.py`) against scripts/ablation_sweep.py's
contract (tests/test_ablation_sweep.py).

The YAML either package writes must be the other's byte for byte, and
each package's `match_conditions` must read run directories written by
the other: the evaluation and the analysis of both read the same
conditions.yaml.
"""

import os

import pytest

from peppa_tpu import config as jax_config
from peppa_tpu_torch import ablation_sweep
from peppa_tpu_torch import config as port_config

NAMES = ["base", "freeze_wav2vec", "jitter", "pretraining_v",
         "pretraining_a", "pretraining_none", "static"]


def _tiny_bases(tmp_path):
    """(port base, JAX base): the sweep's tiny base in each package."""
    port_tiny = ablation_sweep.tiny_base(str(tmp_path / "data"))
    jax_tiny = jax_config.Config.from_dict(port_tiny.to_dict())
    assert jax_tiny.to_dict() == port_tiny.to_dict()
    return port_tiny, jax_tiny


@pytest.mark.parametrize("tiny", [False, True], ids=["default", "tiny"])
def test_conditions_equal_the_jax_packages(tmp_path, tiny):
    port_base, jax_base = _tiny_bases(tmp_path) if tiny else (None, None)
    port = port_config.conditions(port_base)
    jax = jax_config.conditions(jax_base)
    assert list(port) == list(jax) == NAMES
    for name in NAMES:
        assert port[name].to_dict() == jax[name].to_dict(), name
        assert (port_config._comparable(port[name])
                == jax_config._comparable(jax[name])), name
    # each condition differs from base in what the paper changes
    base = port["base"].to_dict()
    assert all(port[n].to_dict() != base for n in NAMES[1:])
    assert port["static"].video.static and port["static"].video.version \
        == "static"


def test_comparable_drops_the_commit_and_the_execution_knobs():
    cfg = port_config.default_config()
    cfg.git_commit = "abc"
    cfg.tpu.remat_audio = True
    d = port_config._comparable(cfg)
    assert "git_commit" not in d and "tpu" not in d
    assert d == port_config._comparable(port_config.default_config())


def test_dumped_conditions_are_the_jax_packages_byte_for_byte(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_config.dump_conditions("port_")
    jax_config.dump_conditions("jax_")
    for name in NAMES:
        with open(f"port_{name}.yaml", "rb") as f:
            port = f.read()
        with open(f"jax_{name}.yaml", "rb") as f:
            assert port == f.read(), name
    # and they are the shipped presets' conditions
    for name in NAMES:
        loaded = port_config.Config.load(f"port_{name}.yaml")
        assert (port_config._comparable(loaded) == port_config._comparable(
            port_config.conditions()[name])), name


def _write_runs(log_dir, package, base, order):
    """One run directory per condition, in `order`, as `package` writes
    hparams.yaml (`Config.dump`), with a run-specific commit and knobs
    that `_comparable` ignores; plus one run that is no condition."""
    conds = package.conditions(base)
    for i, name in enumerate(order):
        cfg = conds[name]
        cfg.git_commit = f"commit{i}"
        cfg.tpu.remat_video = bool(i % 2)
        d = os.path.join(log_dir, f"version_{i}")
        os.makedirs(d)
        cfg.dump(os.path.join(d, "hparams.yaml"))
    odd = package.conditions(base)["base"]
    odd.margin = 0.3
    d = os.path.join(log_dir, f"version_{len(order)}")
    os.makedirs(d)
    odd.dump(os.path.join(d, "hparams.yaml"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_match_conditions_reads_the_other_packages_runs(tmp_path, writer):
    port_base, jax_base = _tiny_bases(tmp_path)
    order = NAMES[3:] + NAMES[:3] + ["jitter", "base"]  # 2 runs of two
    log_dir = str(tmp_path / "logs")
    if writer == "port":
        _write_runs(log_dir, port_config, port_base, order)
    else:
        _write_runs(log_dir, jax_config, jax_base, order)
    want = {name: sorted(i for i, n in enumerate(order) if n == name)
            for name in NAMES}
    port = port_config.match_conditions(log_dir, base=port_base)
    jax = jax_config.match_conditions(log_dir, base=jax_base)
    assert {k: sorted(v) for k, v in port.items()} == want
    assert port == jax
    # `versions` picks runs, and an absent one is skipped
    assert (port_config.match_conditions(log_dir, versions=[0, 99],
                                         base=port_base)
            == jax_config.match_conditions(log_dir, versions=[0, 99],
                                           base=jax_base))
    # conditions.yaml, `keep` runs a condition: byte for byte
    for keep in (4, 1):
        port_path, jax_path = tmp_path / "port.yaml", tmp_path / "jax.yaml"
        port_config.save_conditions(log_dir, str(port_path), keep=keep,
                                    base=port_base)
        jax_config.save_conditions(log_dir, str(jax_path), keep=keep,
                                   base=jax_base)
        assert port_path.read_bytes() == jax_path.read_bytes()


def test_the_port_reads_the_jax_packages_default_condition_runs(tmp_path):
    """tests/test_config.py::test_match_conditions_roundtrip's case, the
    run directories written by the JAX package."""
    log_dir = str(tmp_path / "logs")
    for i, cfg in enumerate(jax_config.conditions().values()):
        d = os.path.join(log_dir, f"version_{i}")
        os.makedirs(d)
        cfg.dump(os.path.join(d, "hparams.yaml"))
    runs = port_config.match_conditions(log_dir)
    for i, name in enumerate(NAMES):
        assert runs[name] == [i], name


def test_tiny_base_is_the_jax_scripts(tmp_path):
    from scripts.ablation_sweep import tiny_base as jax_tiny_base

    data_dir = str(tmp_path / "data")
    for kw in ({}, {"max_epochs": 2, "limit_train_batches": 3,
                    "target_size": (40, 30), "sample_rate": 1600}):
        assert (ablation_sweep.tiny_base(data_dir, **kw).to_dict()
                == jax_tiny_base(data_dir, **kw).to_dict())


def test_the_sweep_raises_without_cuda(monkeypatch, tmp_path):
    """Its entry points default to the card, and raise without it before
    they write anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = str(tmp_path / "work")
    for call in (lambda: ablation_sweep.run_sweep(work),
                 lambda: ablation_sweep.main(["--work-dir", work])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert os.listdir(tmp_path) == []


@pytest.mark.slow  # 7 fits and 7 batteries: 3-4 minutes on the CPU
def test_all_seven_conditions_train_and_tabulate_on_the_cpu(tmp_path):
    """tests/test_ablation_sweep.py's checks on the port's sweep."""
    import pandas as pd

    work = str(tmp_path)
    base = ablation_sweep.tiny_base(os.path.join(work, "data"))
    cond_map, results_dir = ablation_sweep.run_sweep(
        work, base=base, n_samples=20, device="cpu")
    assert sorted(cond_map) == sorted(NAMES)
    versions = [v for vals in cond_map.values() for v in vals]
    assert len(versions) == 7 and len(set(versions)) == 7, cond_map

    scores = pd.read_csv(os.path.join(results_dir, "scores.csv"))
    assert len(scores) == 28, scores  # 7 x 2 fragment types x 2 scramblings
    assert set(scores.version) == set(versions)
    for col in ("triplet_acc", "recall_at_10_fixed", "recall_at_10_jitter"):
        assert scores[col].between(0, 1).all(), scores[col]
    assert scores.static.sum() == 4
    assert (~scores.audio_pretrained).sum() == 8
    assert (~scores.video_pretrained).sum() == 8
    for frag in ("dialog", "narration"):
        with open(os.path.join(results_dir, f"scores_{frag}.tex")) as f:
            assert f.read().count("\\\\") >= 7
