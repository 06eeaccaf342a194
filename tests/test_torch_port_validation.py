"""The port's data, dispatch and four-loader validation against the JAX
package's, on the CPU.

Small sizes: 32x32 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, R(2+1)D-18, float32; the JAX model's variables carried across
with `load_jax_variables`.

- Synthetic clips and every batch the batching functions and
  `SyntheticPigData` make are bit-identical to the JAX package's (same
  numpy generator and formulas).
- The `TripletBatch` forward gives the JAX embeddings within 1e-4, the
  towers' tolerance (PARITY.md).
- `run_validation` gives the same six keys; `val_loss` and `valnarr_loss`
  within rtol 1e-5 (the eval losses of embeddings within 1e-4);
  `val_triplet` and `valnarr_triplet` equal (the same rounds, with no
  similarity difference near the 1e-6 the packages differ by);
  `*_rec_fixed` equal on the JAX package's own subsets, and within 3
  bootstrap standard errors with the port's draws.
"""

import jax
import numpy as np
import pytest
import torch

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data import dataset as jax_dataset
from peppa_tpu.data.datamodule import SyntheticPigData as JaxPigData
from peppa_tpu.data.synthetic import SyntheticClipDataset as JaxClips
from peppa_tpu.data.types import TripletBatch as JaxTripletBatch
from peppa_tpu.evaluation import validation as jax_validation
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.ops.metrics import resampled_recall as jax_resampled_recall
from peppa_tpu.training.step import make_eval_step
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data import dataset
from peppa_tpu_torch.data.datamodule import PigData, SyntheticPigData
from peppa_tpu_torch.data.synthetic import SyntheticClipDataset
from peppa_tpu_torch.data.types import TripletBatch
from peppa_tpu_torch.evaluation import validation
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.ops.metrics import recall_from_indices
from peppa_tpu_torch.training.step import eval_step
from test_torch_port_trainer import _two_threads  # noqa: F401

TOL = 1e-4
RAW = {
    "data": {"target_size": [32, 32], "audio_sample_rate": 800,
             "train": {"batch_size": 4}, "val": {"batch_size": 8}},
    "audio": {"num_layers": 2},
    "training": {"trainer_args": {"precision": 32}},
    "tpu": {"bucket_durations": [2.3, 3.2]},
}
N_VAL = 24
SIZE = 16  # bootstrap subsets of 16 of the 24 pairs: a spread to compare
KEYS = {"val_loss", "val_rec_fixed", "valnarr_loss", "valnarr_rec_fixed",
        "val_triplet", "valnarr_triplet"}


def _fields(batch):
    return {k: np.asarray(v) for k, v in vars(batch).items()}


def _assert_same_batches(want_iter, got_iter):
    want, got = list(want_iter), list(got_iter)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        w, g = _fields(w), _fields(g)
        assert w.keys() == g.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("correlated,n_classes", [(True, 8), (True, 64),
                                                  (False, 8)])
def test_synthetic_clips_are_bit_identical(correlated, n_classes):
    durs = [2.3, 1.0, 3.0, 0.05]
    kw = dict(target_size=(40, 24), sample_rate=800, seed=3,
              correlated=correlated, n_classes=n_classes)
    want, got = JaxClips(durs, **kw), SyntheticClipDataset(durs, **kw)
    assert len(got) == len(want)
    for i in range(len(durs)):
        w, g = want[i], got[i]
        assert g.video.dtype == np.uint8 and g.audio.dtype == np.float32
        np.testing.assert_array_equal(g.video, w.video)
        np.testing.assert_array_equal(g.audio, w.audio)
        assert (g.video_duration, g.audio_duration, g.filename, g.index) == \
            (w.video_duration, w.audio_duration, w.filename, w.index)
    with pytest.raises(IndexError):
        got[len(durs)]


def test_batching_functions_match_jax():
    durs = [2.3, 1.0, 3.0, 2.3, 1.0, 2.0, 3.0, 1.0, 2.3, 0.5, 2.0]
    kw = dict(target_size=(32, 32), sample_rate=800, seed=1)
    want_ds, got_ds = JaxClips(durs, **kw), SyntheticClipDataset(durs, **kw)
    clips = [got_ds[i] for i in (0, 1, 2)]
    _assert_same_batches(
        [jax_dataset.collate([want_ds[i] for i in (0, 1, 2)])],
        [dataset.collate(clips)])
    _assert_same_batches(
        [jax_dataset.collate([want_ds[i] for i in (0, 1, 2)], 20, 1000)],
        [dataset.collate(clips, video_frames=20, audio_samples=1000)])
    _assert_same_batches(
        jax_dataset.batches(want_ds, 3, shuffle=True, seed=4),
        dataset.batches(got_ds, 3, shuffle=True, seed=4))
    _assert_same_batches(
        jax_dataset.batches(want_ds, 4, drop_last=True),
        dataset.batches(got_ds, 4, drop_last=True))
    key = lambda c: c.audio_duration
    _assert_same_batches(jax_dataset.grouped_batches(want_ds, key, 2),
                         dataset.grouped_batches(got_ds, key, 2))
    for drop_last in (True, False):
        _assert_same_batches(
            jax_dataset.bucketed_batches(want_ds, 2, (1.0, 2.3, 3.2),
                                         sample_rate=800, shuffle=True,
                                         seed=2, drop_last=drop_last),
            dataset.bucketed_batches(got_ds, 2, (1.0, 2.3, 3.2),
                                     sample_rate=800, shuffle=True, seed=2,
                                     drop_last=drop_last))
    assert dataset.bucket_for(2.4, (1.0, 2.3)) == 2.3
    np.testing.assert_array_equal(dataset.pad_to(np.arange(3), 5),
                                  [0, 1, 2, 0, 0])


def test_synthetic_pig_data_matches_jax(tmp_path):
    jax_cfg, cfg = JaxConfig.from_dict(RAW), Config.from_dict(RAW)
    want = JaxPigData(jax_cfg, n_train=12, n_val=10, seed=2)
    got = SyntheticPigData(cfg, n_train=12, n_val=10, seed=2)
    want.setup()
    got.setup()
    for epoch in (0, 1):
        _assert_same_batches(want.train_batches(epoch),
                             got.train_batches(epoch))
    for w, g in zip(want.val_loaders(), got.val_loaders()):
        _assert_same_batches(w, g)
    cfg.data.data_dir = str(tmp_path)  # no episode tree there
    with pytest.raises(RuntimeError, match="Extract the data first"):
        PigData(cfg).setup()


@pytest.fixture(scope="module")
def models():
    jax_cfg, cfg = JaxConfig.from_dict(RAW), Config.from_dict(RAW)
    assert cfg.to_dict() == jax_cfg.to_dict()
    jax_model, variables = jax_init_model(jax_cfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    port = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(port, variables)
    return jax_cfg, jax_model, variables, cfg, port


def test_triplet_batch_forward_matches_jax(models):
    _, jax_model, variables, _, port = models
    rng = np.random.default_rng(0)
    anchor = rng.normal(scale=0.1, size=(3, 1840)).astype(np.float32)
    pos = rng.integers(0, 256, size=(3, 12, 32, 32, 3)).astype(np.uint8)
    neg = rng.integers(0, 256, size=(3, 12, 32, 32, 3)).astype(np.uint8)
    want = jax_model.apply(variables, JaxTripletBatch(anchor, pos, neg))
    got = eval_step(port, TripletBatch(anchor, pos, neg), device="cpu")
    assert isinstance(got, TripletBatch)
    for name in ("anchor", "positive", "negative"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape == (3, 512)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    with torch.inference_mode():
        direct = port(TripletBatch(anchor, pos, neg).to("cpu"))
    np.testing.assert_array_equal(direct.anchor.numpy(), got.anchor.numpy())


@pytest.fixture(scope="module")
def validations(models):
    jax_cfg, jax_model, variables, cfg, port = models
    jax_data = JaxPigData(jax_cfg, n_train=4, n_val=N_VAL)
    data = SyntheticPigData(cfg, n_train=4, n_val=N_VAL)
    jax_data.setup()
    data.setup()
    jax_step = make_eval_step(jax_model)
    out = {
        "jax": jax_validation.run_validation(
            jax_step, variables, jax_data.val_loaders(), n_samples=200,
            size=SIZE),
        "port": validation.run_validation(port, data.val_loaders(), "cpu",
                                          n_samples=200, size=SIZE),
        "jax_enc": jax_validation.encode_loader(
            jax_step, variables, jax_data.val_loaders()[0],
            collect_loss=True),
        "port_enc": validation.encode_loader(
            port, data.val_loaders()[0], "cpu", collect_loss=True),
    }
    return out


def test_run_validation_keys_losses_and_triplets(validations):
    want, got = validations["jax"], validations["port"]
    assert set(got) == set(want) == KEYS
    for k in ("val_loss", "valnarr_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("val_triplet", "valnarr_triplet"):
        assert got[k] == want[k], k


def test_encode_loader_matches_jax(validations):
    want, got = validations["jax_enc"], validations["port_enc"]
    assert got["video"].shape == (N_VAL, 512)
    for k in ("video", "audio"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(got["loss"].item(), want["loss"], rtol=1e-5)


def test_rec_fixed_on_jax_subsets_and_within_bootstrap_spread(validations):
    want, got = validations["jax_enc"], validations["port_enc"]
    key = jax.random.PRNGKey(0)  # run_validation's key for seed 0
    jax_rec = np.asarray(jax_resampled_recall(
        want["video"], want["audio"], key, size=SIZE, n_samples=200, n=10))
    np.testing.assert_allclose(jax_rec.mean(),
                               validations["jax"]["val_rec_fixed"], rtol=1e-6)
    keys = jax.random.split(key, 200)
    idx = np.stack([np.asarray(jax.random.permutation(k, N_VAL)[:SIZE])
                    for k in keys])
    rec = recall_from_indices(got["video"], got["audio"],
                              torch.from_numpy(idx), n=10).numpy()
    np.testing.assert_array_equal(rec, jax_rec)
    # the port's own draws: within the bootstrap spread of the JAX mean
    per = jax_rec.mean(axis=1)
    se = per.std() / np.sqrt(len(per))
    assert se > 0
    for k in ("val_rec_fixed", "valnarr_rec_fixed"):
        assert abs(validations["port"][k] - validations["jax"][k]) \
            <= 3 * np.sqrt(2) * se, k
