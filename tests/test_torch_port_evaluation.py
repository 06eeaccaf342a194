"""The evaluation battery (`evaluation/evaluation.py`) and its CLI against
the JAX package's, on a tiny episode tree written by each package (the two
trees are equal: tests/test_torch_port_data.py) and carried-across
weights.

- Unscrambled triplet accuracy: equal to the JAX package's (the same
  `random.Random(666)` rounds).
- Recall of the fixed windows: the embeddings within 1e-4; the JAX
  package's bootstrap subsets (`jax.random`, key 666) fed through
  `recall_curve_from_indices` give the JAX package's curves; the port's
  own draws within the bootstrap spread of the JAX mean.
- Jittered windows: held to the JAX package's by their clip boundaries
  (the two packages' jitter caches, built under one `random` seed, are
  equal), not by a JAX forward (one compile per jittered duration).
- Scrambled rows: unseeded in both packages, compared by shape and range.
(tests/test_torch_port_eval_cli.py holds the CLI's result file.)

Small sizes: 32x24 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, float32, 50 bootstrap samples.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch

import peppa_tpu.evaluation.evaluation as JE
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.dataset import PeppaPigDataset as JaxDataset
from peppa_tpu.data.synthetic import \
    make_synthetic_episode_tree as jax_make_tree
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.ops.metrics import resampled_recall_at_1_to_n as jax_recall
import peppa_tpu_torch.evaluation.evaluation as E
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.dataset import PeppaPigDataset
from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
from peppa_tpu_torch.models.convert import export_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from peppa_tpu_torch.ops.metrics import recall_curve_from_indices
from test_torch_port_convert import _random, _two_threads  # noqa: F401

EPISODES = {"dialog": (197, 198), "narration": (1, 2)}
RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}}}
N_SAMPLES = 50
TOL = 1e-4
ROW_KEYS = {"fragment_type", "scrambled_video", "triplet_acc",
            "recall_fixed", "recall_jitter", "recall_at_10_fixed",
            "recall_at_10_jitter"}


def _tree(root, make):
    for fragment, episodes in EPISODES.items():
        make(str(root), target_size=(32, 24), fragment_type=fragment,
             episodes=episodes, clips_per_episode=2, clip_seconds=7.0,
             sample_rate=800, seed=1, correlated=True)
    return str(root)


def _jitter_caches(data_dir, dataset_cls):
    """Build the jittered-window caches of both fragment types under one
    `random` seed (full_score then reads them)."""
    dirs = []
    for fragment in EPISODES:
        random.seed(7)
        ds = dataset_cls(target_size=(32, 24), split=["val"],
                         fragment_type=fragment, duration=2.3,
                         audio_sample_rate=800, jitter=True, jitter_sd=0.5,
                         data_dir=data_dir)
        dirs.append(ds.cache_dir)
    return dirs


class _Recording:
    """A predict function that keeps the embeddings it returns."""

    def __init__(self, predict):
        self.predict, self.video, self.audio = predict, [], []

    def __call__(self, batch):
        out = self.predict(batch)
        self.video.append(np.asarray(out.video))
        self.audio.append(np.asarray(out.audio))
        return out

    def embeddings(self):
        return np.concatenate(self.video), np.concatenate(self.audio)


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    torch.set_num_threads(2)
    port_dir = _tree(tmp_path_factory.mktemp("port"),
                     make_synthetic_episode_tree)
    jax_dir = _tree(tmp_path_factory.mktemp("jax"), jax_make_tree)
    cfg = Config.from_dict({**RAW, "data": {**RAW["data"],
                                            "data_dir": port_dir}})
    jcfg = JaxConfig.from_dict({**RAW, "data": {**RAW["data"],
                                                "data_dir": jax_dir}})
    model = _random(PeppaPig(cfg), seed=1)
    variables = export_jax_variables(model)
    caches = (_jitter_caches(port_dir, PeppaPigDataset),
              _jitter_caches(jax_dir, JaxDataset))
    rows = E.full_score(model, cfg, n_samples=N_SAMPLES, device="cpu")
    jax_predict = JE.make_predict(JaxPeppaPig(jcfg), variables)
    return dict(port_dir=port_dir, jax_dir=jax_dir, cfg=cfg, jcfg=jcfg,
                model=model, variables=variables, rows=rows, caches=caches,
                jax_predict=jax_predict)


def _row(rows, fragment, scrambled):
    (row,) = [r for r in rows if r["fragment_type"] == fragment
              and r["scrambled_video"] == scrambled]
    return row


def test_rows_have_the_jax_structure(battery, monkeypatch):
    """Keys, shapes and dtypes of the JAX package's `full_score` rows (its
    forward replaced by a stand-in of the right shapes: the structure
    needs no compile)."""
    def fake_predict(model, variables):
        rng = np.random.default_rng(0)

        def run(batch):
            b = batch.audio.shape[0]
            v = rng.normal(size=(b, 512)).astype(np.float32)
            a = rng.normal(size=(b, 512)).astype(np.float32)
            return type(batch)(video=v, audio=a,
                               video_duration=batch.video_duration,
                               audio_duration=batch.audio_duration)
        return run

    monkeypatch.setattr(JE, "make_predict", fake_predict)
    want = JE.full_score(None, None, battery["jcfg"], n_samples=N_SAMPLES)
    got = battery["rows"]
    assert [(r["fragment_type"], r["scrambled_video"]) for r in got] \
        == [(r["fragment_type"], r["scrambled_video"]) for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w) == ROW_KEYS
        for k in ROW_KEYS - {"fragment_type", "scrambled_video"}:
            assert isinstance(g[k], np.ndarray), k
            assert g[k].shape == np.asarray(w[k]).shape, k
            assert g[k].dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(g["recall_at_10_fixed"],
                                      g["recall_fixed"][:, 10, :])
        np.testing.assert_array_equal(g["recall_at_10_jitter"],
                                      g["recall_jitter"][:, 10, :])
        assert g["recall_fixed"].shape[1] == 11
        for k in ("triplet_acc", "recall_fixed", "recall_jitter"):
            assert ((g[k] >= 0) & (g[k] <= 1)).all(), k


@pytest.mark.parametrize("fragment", list(EPISODES))
def test_unscrambled_triplet_accuracy_equals_jax(battery, fragment):
    want = JE.triplet_score(fragment, battery["jax_predict"], (32, 24),
                            audio_sample_rate=800, data_dir=battery["jax_dir"],
                            n_samples=N_SAMPLES)
    got = _row(battery["rows"], fragment, False)["triplet_acc"]
    assert got.dtype == np.asarray(want["accuracy"]).dtype
    np.testing.assert_array_equal(got, np.asarray(want["accuracy"]))


@pytest.mark.parametrize("fragment", list(EPISODES))
def test_fixed_recall_on_jax_subsets_and_within_spread(battery, fragment):
    kw = dict(target_size=(32, 24), duration=2.3, audio_sample_rate=800,
              one_to_n=True, n_samples=N_SAMPLES)
    port_rec = _Recording(E.make_predict(battery["model"], "cpu"))
    again = E.resampled_retrieval_score(fragment, port_rec,
                                        data_dir=battery["port_dir"], **kw)
    got = _row(battery["rows"], fragment, False)["recall_fixed"]
    np.testing.assert_array_equal(again, got)  # deterministic
    jax_rec = _Recording(battery["jax_predict"])
    want = JE.resampled_retrieval_score(fragment, jax_rec,
                                        data_dir=battery["jax_dir"], **kw)
    (pv, pa), (jv, ja) = port_rec.embeddings(), jax_rec.embeddings()
    np.testing.assert_allclose(pv, jv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pa, ja, rtol=TOL, atol=TOL)
    size = got.shape[2]
    keys = jax.random.split(jax.random.PRNGKey(E.EVAL_SEED), N_SAMPLES)
    idx = np.stack([np.asarray(jax.random.permutation(k, len(pv))[:size])
                    for k in keys])
    np.testing.assert_array_equal(np.asarray(jax_recall(
        jv, ja, jax.random.PRNGKey(E.EVAL_SEED), size=size,
        n_samples=N_SAMPLES, N=10)), np.asarray(want))
    on_jax_subsets = recall_curve_from_indices(
        torch.from_numpy(pv), torch.from_numpy(pa), torch.from_numpy(idx),
        N=10).numpy()
    np.testing.assert_array_equal(on_jax_subsets, np.asarray(want))
    # the port's own draws: within the bootstrap spread of the JAX mean
    # (here fewer than 100 clips, so every subset is the whole set, in
    # another order, and the spread is 0)
    per = np.asarray(want)[:, 10, :].mean(axis=1)
    se = per.std() / np.sqrt(len(per))
    assert abs(got[:, 10, :].mean() - per.mean()) \
        <= 3 * np.sqrt(2) * se + 1e-6


def test_jittered_windows_equal_jax(battery):
    """The jittered windows' caches of the two packages, built under one
    `random` seed, hold the same clips."""
    for port_cache, jax_cache in zip(*battery["caches"]):
        assert os.path.basename(port_cache) == os.path.basename(jax_cache)
        names = sorted(os.listdir(port_cache))
        assert names == sorted(os.listdir(jax_cache)) and len(names) > 2
        for name in names:
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(port_cache, name)) as a, \
                    np.load(os.path.join(jax_cache, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    if k == "filename":  # each tree's own absolute path
                        assert os.path.relpath(
                            a[k].tobytes().decode(), battery["port_dir"]) \
                            == os.path.relpath(b[k].tobytes().decode(),
                                               battery["jax_dir"])
                        continue
                    np.testing.assert_array_equal(a[k], b[k], err_msg=name)


def test_scrambled_rows(battery):
    for fragment in EPISODES:
        plain = _row(battery["rows"], fragment, False)
        scrambled = _row(battery["rows"], fragment, True)
        for k in ("triplet_acc", "recall_fixed", "recall_jitter"):
            assert scrambled[k].shape == plain[k].shape, k
            assert ((scrambled[k] >= 0) & (scrambled[k] <= 1)).all(), k
        # recall@0 is 0 and the curve never falls
        assert (scrambled["recall_fixed"][:, 0, :] == 0).all()
        assert (np.diff(scrambled["recall_fixed"], axis=1) >= 0).all()
