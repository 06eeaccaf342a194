"""The targeted (minimal-pairs) triplets (`evaluation/targeted.py`) against
the JAX package's, on tests/test_targeted.py's fixture (one synthetic
episode, three minimal pairs) written once for each package: the cut
clips, `clip_info.json`, `sample.json` and the item cache are the JAX
package's; `targeted_triplet_score` is equal per sample on carried-across
weights, with the video scrambled (seed 666) and not.  The CSV is read
with the `csv` module: its floats parse as pandas parses them (the same
clip boundaries, also on many-digit stamps where Python's `float` differs
from pandas), and an empty transcript is NaN in `clip_info.json`, as the
JAX package writes it.

Small sizes: 32x24 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, float32.
"""

import io
import json
import os

import numpy as np
import pandas as pd
import pytest

import peppa_tpu.evaluation.targeted as JT
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.evaluation.evaluation import make_predict as jax_make_predict
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
import peppa_tpu_torch.evaluation.targeted as T
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.evaluation.evaluation import make_predict
from peppa_tpu_torch.models.convert import export_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from test_targeted import SR, TS, make_episode, make_eval_csv
from test_torch_port_convert import _random, _two_threads  # noqa: F401

RAW = {"data": {"target_size": list(TS), "audio_sample_rate": SR},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}}}
KW = dict(target_size=TS, audio_sample_rate=SR)


def _data(root):
    """test_targeted.py's episode and eval set under `root`, with one
    transcript left empty."""
    episode = make_episode(root, np.random.default_rng(0))
    info = make_eval_csv(root, episode)
    info.loc[3, "transcript"] = ""
    info.to_csv(root / "data" / "eval" / "eval_set_narration_NOUN.csv")
    return str(root / "data")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return (_data(tmp_path_factory.mktemp("port")),
            _data(tmp_path_factory.mktemp("jax")))


def _text(path, root):
    with open(path) as f:
        return f.read().replace(os.path.dirname(root), "<root>")


def test_clips_clip_info_and_sample_equal_jax(trees):
    port_ds = T.PeppaTargetedTripletDataset.from_csv("narration", "NOUN",
                                                     data_dir=trees[0], **KW)
    jax_ds = JT.PeppaTargetedTripletDataset.from_csv("narration", "NOUN",
                                                     data_dir=trees[1], **KW)
    assert len(port_ds) == len(jax_ds) == 6
    for name in ("clip_info.json", "sample.json"):
        got = _text(os.path.join(port_ds.directory, name), trees[0])
        want = _text(os.path.join(jax_ds.directory, name), trees[1])
        assert got == want, name
    info = json.loads(_text(os.path.join(port_ds.directory, "clip_info.json"),
                            trees[0]))
    assert info["3"]["transcript"] != info["3"]["transcript"]  # NaN
    for i in range(len(port_ds)):
        a, b = port_ds[i], jax_ds[i]
        for k in ("anchor", "positive", "negative"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (a.audio_duration, a.video_duration) \
            == (b.audio_duration, b.video_duration)


@pytest.mark.parametrize("scrambled", [False, True])
def test_cached_dataset_equals_jax(trees, scrambled):
    port = T.PeppaTargetedTripletCachedDataset(
        "narration", "NOUN", data_dir=trees[0], scrambled_video=scrambled,
        scramble_seed=666, **KW)
    jax_ds = JT.PeppaTargetedTripletCachedDataset(
        "narration", "NOUN", data_dir=trees[1], scrambled_video=scrambled,
        scramble_seed=666, **KW)
    assert os.path.basename(port.cache_dir) == os.path.basename(
        jax_ds.cache_dir)
    assert len(port) == len(jax_ds) == 6
    for i in range(len(port)):
        a, b = port[i], jax_ds[i]
        for k in ("anchor", "positive", "negative"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    batch, want = (T.collate_triplets([port[0], port[1], port[2]]),
                   JT.collate_triplets([jax_ds[0], jax_ds[1], jax_ds[2]]))
    for k in ("anchor", "positive", "negative"):
        np.testing.assert_array_equal(getattr(batch, k), getattr(want, k))


@pytest.mark.parametrize("scrambled", [False, True])
def test_targeted_triplet_score_equals_jax(trees, scrambled):
    cfg = Config.from_dict(RAW)
    model = _random(PeppaPig(cfg), seed=1)
    variables = export_jax_variables(model)
    got = T.targeted_triplet_score(
        "narration", "NOUN", make_predict(model, "cpu"), batch_size=4,
        scrambled_video=scrambled, data_dir=trees[0], **KW)
    want = JT.targeted_triplet_score(
        "narration", "NOUN",
        jax_make_predict(JaxPeppaPig(JaxConfig.from_dict(RAW)), variables),
        batch_size=4, scrambled_video=scrambled, data_dir=trees[1], **KW)
    assert got.dtype == want.dtype and got.shape == want.shape == (6,)
    np.testing.assert_array_equal(got, want)


def test_csv_floats_parse_as_pandas_parses_them():
    """`csv_float` is pandas' default parser: the same doubles over many
    stamps (with up to 22 digits, where Python's float, correctly rounded,
    differs from pandas on many), so the same frame and sample cut
    indices and the same `duration` in clip_info.json."""
    rng = np.random.default_rng(3)
    stamps = []
    for _ in range(20000):
        digits = "".join(map(str, rng.integers(0, 10, size=rng.integers(
            0, 23))))
        whole = int(rng.integers(0, 1500))
        stamps.append(f"{whole}.{digits}" if digits else str(whole))
    stamps += ["0.1", "1e2", "-2.25", "1.5E-3", "12", "3.0000000000000000001"]
    frame = pd.read_csv(io.StringIO("t\n" + "\n".join(stamps) + "\n"))
    want = frame["t"].to_numpy()
    got = np.array([T.csv_float(s) for s in stamps])
    np.testing.assert_array_equal(got, want)
    python = np.array([float(s) for s in stamps])
    assert (python != want).sum() > 100  # where a plain float() goes wrong
    for rate in (10, SR, 44100):
        np.testing.assert_array_equal(np.round(got * rate),
                                      np.round(want * rate))
    np.testing.assert_array_equal(got[1:] - got[:-1], want[1:] - want[:-1])


def test_eval_set_info_is_the_csv(trees):
    columns, rows = T.get_eval_set_info("narration", "NOUN", trees[0])
    frame = JT.get_eval_set_info("narration", "NOUN", trees[0])
    assert columns == ["id"] + list(frame.columns)
    assert [int(r["id"]) for r in rows] == list(frame.index)
    assert [int(r["id_counterexample"]) for r in rows] \
        == list(frame["id_counterexample"])
