"""The port's two evaluation CLIs against the JAX package's, on one
JAX-package run directory (flax msgpack written by the port's encoder,
hparams.yaml, a sidecar) that both packages read:

- `python -m peppa_tpu_torch.evaluate` writes `full_scores_vN.pt` with the
  keys, shapes and dtypes of root `evaluate.py`'s (its forward replaced by
  a stand-in of the right shapes: the structure needs no compile), and the
  scores of `full_score` on the loaded model;
- `python -m peppa_tpu_torch.targeted_eval --run` writes
  `minimal_pairs_scores.csv` with the columns, row order and values of
  `evaluation_targeted_triplets.py --run`'s (a real JAX forward: the
  results compare per sample).

Small sizes: 32x24 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, float32, 50 bootstrap samples.
"""

import importlib
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import peppa_tpu.evaluation.evaluation as JE
import peppa_tpu_torch.evaluation.evaluation as E
from peppa_tpu_torch import evaluate, targeted_eval
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
from peppa_tpu_torch.models.convert import export_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from peppa_tpu_torch.training.flax_msgpack import write_checkpoint
from test_targeted import make_episode, make_eval_csv
from test_torch_port_convert import (_random, _two_threads,  # noqa: F401
                                     remove_large_files)
from test_torch_port_evaluation import EPISODES, N_SAMPLES, RAW, ROW_KEYS

POS_TAGS = ("ADJ", "VERB", "NOUN")


def _run_dir(log_dir, cfg, variables):
    """version_0 of a JAX-package run: hparams.yaml, one scored msgpack
    checkpoint and its sidecar."""
    vdir = os.path.join(log_dir, "version_0")
    os.makedirs(os.path.join(vdir, "checkpoints"))
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    path = os.path.join(vdir, "checkpoints",
                        "epoch=0-valnarr_triplet=0.50.ckpt")
    write_checkpoint(path, {"step": np.asarray(0, np.int32), **variables,
                            "opt_state": {}})
    with open(path + ".json", "w") as f:
        json.dump({"monitor": "valnarr_triplet", "best_model_score": 0.5,
                   "best_model_path": path}, f)
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("cli")
    data_dir = str(root / "data")
    for fragment, episodes in EPISODES.items():
        make_synthetic_episode_tree(data_dir, target_size=(32, 24),
                                    fragment_type=fragment,
                                    episodes=episodes, clips_per_episode=2,
                                    clip_seconds=7.0, sample_rate=800,
                                    seed=1, correlated=True)
    # the minimal-pairs sets (tests/test_targeted.py's), one per POS tag
    info = make_eval_csv(root, make_episode(root, np.random.default_rng(0)))
    for pos in POS_TAGS:
        info.to_csv(os.path.join(data_dir, "eval",
                                 f"eval_set_narration_{pos}.csv"))
    cfg = Config.from_dict({**RAW, "data": {**RAW["data"],
                                            "data_dir": data_dir}})
    model = _random(PeppaPig(cfg), seed=2)
    path = _run_dir(str(root / "logs"), cfg, export_jax_variables(model))
    yield dict(root=root, data_dir=data_dir, cfg=cfg, model=model,
               log_dir=str(root / "logs"), path=path)
    remove_large_files(root)


def test_evaluate_cli_file_matches_the_jax_cli(run, monkeypatch):
    root = run["root"]
    assert evaluate.main(["--versions", "0", "--log_dir", run["log_dir"],
                          "--results_dir", str(root / "port"),
                          "--n_samples", str(N_SAMPLES),
                          "--device", "cpu"]) == 0
    got = torch.load(str(root / "port" / "full_scores_v0.pt"),
                     weights_only=False)

    def stand_in(model, variables):
        def predict(batch):
            n = batch.audio.shape[0]
            return type(batch)(video=np.ones((n, 512), np.float32),
                               audio=np.ones((n, 512), np.float32),
                               video_duration=batch.video_duration,
                               audio_duration=batch.audio_duration)
        return predict

    monkeypatch.setattr(JE, "make_predict", stand_in)
    JE.full_run(versions=["0"], log_dir=run["log_dir"],
                results_dir=str(root / "jax"), n_samples=N_SAMPLES)
    want = torch.load(str(root / "jax" / "full_scores_v0.pt"),
                      weights_only=False)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) and ROW_KEYS < set(g)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert isinstance(g[k], np.ndarray), k
                assert g[k].shape == v.shape and g[k].dtype == v.dtype, k
            elif k not in ROW_KEYS:
                assert g[k] == v, k  # version, paths, condition columns
    # the scores are the run's model's: its narration recall, fixed windows
    (row,) = [g for g in got if g["fragment_type"] == "narration"
              and not g["scrambled_video"]]
    want_fixed = E.resampled_retrieval_score(
        "narration", E.make_predict(run["model"], "cpu"), (32, 24),
        audio_sample_rate=800, one_to_n=True, data_dir=run["data_dir"],
        n_samples=N_SAMPLES)
    np.testing.assert_array_equal(row["recall_fixed"], want_fixed)


def test_targeted_cli_csv_matches_the_jax_cli(run, monkeypatch):
    root = run["root"]
    assert targeted_eval.main([
        "--run", "--versions", "0", "--log_dir", run["log_dir"],
        "--data_dir", run["data_dir"], "--results_dir",
        str(root / "port_targeted"), "--device", "cpu"]) == 0
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ett = importlib.import_module("evaluation_targeted_triplets")
    monkeypatch.setattr(ett, "RESULTS_DIR", str(root / "jax_targeted"))
    ett.evaluate("0", log_dir=run["log_dir"], data_dir=run["data_dir"])
    got_path = root / "port_targeted" / "version_0" / \
        "minimal_pairs_scores.csv"
    want_path = root / "jax_targeted" / "version_0" / \
        "minimal_pairs_scores.csv"
    assert got_path.read_text().splitlines()[0] \
        == want_path.read_text().splitlines()[0]
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert len(got) == 2 * len(POS_TAGS) * 6
    pd.testing.assert_frame_equal(got, want)
