"""`duration_effect` and `duration_effect_scramble` of the port against the
JAX package's, over the same run directories (JAX format), episode trees
and conditions.yaml: the .pt files have the same keys, `model_ids` and
`scrambled_video`, equal durations, and `success` within 1e-4.

The two packages' forwards are held to each other elsewhere
(tests/test_torch_port_evaluation.py, tests/test_torch_port_load_best.py);
here the JAX package's `make_predict` runs the port's model on the JAX
weights it loaded, so that no JAX forward is compiled per batch shape and
model, and what is compared is the rest of the path: the runs loaded in
conditions.yaml's order, the val lines encoded per fragment type and
scrambling, the `random.Random(666)` rounds and the similarity
differences.  Scrambled video is shuffled by an unseeded generator in both
packages; the test seeds it alike for each (numpy's `default_rng(None)`
becomes `default_rng(0)`).

Small sizes: 32x24 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, float32.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

import peppa_tpu.evaluation.evaluation as JE
import peppa_tpu_torch.evaluation.evaluation as E
from peppa_tpu_torch.analysis.plotting import duration_effect_plot
from peppa_tpu.data.synthetic import \
    make_synthetic_episode_tree as jax_make_tree
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from test_torch_port_convert import _random, remove_large_files
from torch_port_grsa_run import write_jax_run

EPISODES = {"dialog": (197, 198), "narration": (1, 2)}
RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}}}
CONDITIONS = {"base": [0], "pretraining_a": [1], "static": [2]}
TOL = 1e-4


def _tree(root, make):
    for fragment, episodes in EPISODES.items():
        make(str(root), target_size=(32, 24), fragment_type=fragment,
             episodes=episodes, clips_per_episode=2, clip_seconds=7.0,
             sample_rate=800, seed=1, correlated=True)
    return str(root)


def _port_predict(model, variables):
    """The JAX `make_predict` replaced: the port's model, given the JAX
    weights, run on the JAX package's numpy batches."""
    port = PeppaPig(Config.from_dict(model.config.to_dict())).eval()
    load_jax_variables(port, jax.tree.map(np.asarray, variables))
    predict = E.make_predict(port, "cpu")

    def run(batch):
        out = predict(ClipBatch(**{f: getattr(batch, f) for f in (
            "video", "audio", "video_duration", "audio_duration",
            "video_frames", "audio_samples")}))
        return type(batch)(video=out.video.numpy(), audio=out.audio.numpy(),
                           video_duration=batch.video_duration,
                           audio_duration=batch.audio_duration)
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same three runs (base, pretraining_a, static) under a log
    directory for each package, each over its package's episode tree."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("duration")
    models = {}
    for version, seed, video in ((0, 1, {}), (1, 2, {}),
                                 (2, 3, {"static": True})):
        cfg = Config.from_dict({**RAW, "video": video})
        models[version] = (_random(PeppaPig(cfg), seed=seed), cfg)
    sides = {}
    for side, make in (("port", make_synthetic_episode_tree),
                       ("jax", jax_make_tree)):
        data_dir = _tree(root / f"{side}_data", make)
        log_dir = root / f"{side}_runs"
        for version, (model, cfg) in models.items():
            cfg = Config.from_dict({**cfg.to_dict(), "data": {
                **cfg.to_dict()["data"], "data_dir": data_dir}})
            vdir = log_dir / f"version_{version}"
            if side == "port":
                write_jax_run(str(vdir), model, cfg)
                continue
            # the port's checkpoint files, linked, beside this hparams.yaml
            src = root / "port_runs" / f"version_{version}"
            os.makedirs(vdir / "checkpoints")
            for name in os.listdir(src / "checkpoints"):
                os.link(src / "checkpoints" / name,
                        vdir / "checkpoints" / name)
            cfg.dump(str(vdir / "hparams.yaml"))
        sides[side] = str(log_dir)
    with open(root / "conditions.yaml", "w") as f:
        yaml.safe_dump(CONDITIONS, f)
    yield {"root": root, **sides}
    remove_large_files(root)


def _seeded_scramble(monkeypatch):
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(0 if seed is None else seed))


@pytest.mark.parametrize("name", ["duration_effect",
                                  "duration_effect_scramble"])
def test_duration_effect_matches_jax(runs, monkeypatch, name):
    """Each file against the JAX package's, then the port's figure of it."""
    root = runs["root"]
    monkeypatch.chdir(root)  # the JAX package reads ./conditions.yaml
    monkeypatch.setattr(JE, "make_predict", _port_predict)
    with monkeypatch.context() as mp:
        _seeded_scramble(mp)
        getattr(JE, name)(log_dir=runs["jax"],
                          results_dir=str(root / "jax_results"))
    with monkeypatch.context() as mp:
        _seeded_scramble(mp)
        getattr(E, name)(log_dir=runs["port"],
                         results_dir=str(root / "port_results"),
                         conditions_path=str(root / "conditions.yaml"),
                         device="cpu")
    got, want = (torch.load(root / side / f"{name}.pt", weights_only=False)
                 for side in ("port_results", "jax_results"))
    assert [r["fragment_type"] for r in got] == ["dialog", "narration"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["fragment_type"] == w["fragment_type"]
        assert g["model_ids"] == w["model_ids"]
        if name.endswith("scramble"):
            assert g["model_ids"] == [0, 0]
            assert g["scrambled_video"] == w["scrambled_video"] == [False,
                                                                   True]
        else:
            assert g["model_ids"] == [1, 2]
            assert "scrambled_video" not in g
        assert g["duration"].dtype == w["duration"].dtype
        np.testing.assert_array_equal(g["duration"], w["duration"])
        assert len(g["success"]) == len(w["success"]) == 2
        for s, t in zip(g["success"], w["success"]):
            assert s.shape == t.shape == g["duration"].shape
            np.testing.assert_allclose(s, t, rtol=TOL, atol=TOL)
    # the port's file feeds the port's figure
    duration_effect_plot(str(root / "conditions.yaml"),
                         str(root / "port_results"),
                         scramble=name.endswith("scramble"))
    assert os.path.getsize(root / "port_results" / f"{name}.pdf") > 0
