"""The port's own copies of the JAX package's jax-free modules: config,
request batching, normalisation stats; and the weight carry-across's
refusals."""

import glob
import os

import jax
import numpy as np
import pytest

from peppa_tpu import config as jax_config
from peppa_tpu.models import normalization as jax_norm
from peppa_tpu.utils import request_batching as jax_batching
from peppa_tpu_torch import config
from peppa_tpu_torch.models import normalization
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.utils import request_batching

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(ROOT, "hparams_*.yaml")))


@pytest.mark.parametrize("path", PRESETS, ids=os.path.basename)
def test_config_presets_load_alike(path):
    assert (config.Config.load(path).to_dict()
            == jax_config.Config.load(path).to_dict())


@pytest.mark.parametrize("path", PRESETS, ids=os.path.basename)
def test_config_presets_leave_int8_off(path):
    """W8A8 serving (`tpu.quantize_int8`) is opt-in, as in the JAX package:
    no committed preset turns it on."""
    assert config.Config.load(path).tpu.quantize_int8 is False


def test_quantize_int8_keeps_the_state_dict():
    """`PeppaPig` builds with `tpu.quantize_int8` and has the float model's
    state-dict keys and shapes, so `load_jax_variables` is unchanged: the
    float model's JAX variables load into it."""
    from peppa_tpu_torch.models.convert import export_jax_variables
    from peppa_tpu_torch.models.dual_encoder import PeppaPig

    raw = {"audio": {"num_layers": 1}}
    q = PeppaPig(config.Config.from_dict({**raw,
                                          "tpu": {"quantize_int8": True}}))
    f = PeppaPig(config.Config.from_dict(raw))
    assert ({k: v.shape for k, v in q.state_dict().items()}
            == {k: v.shape for k, v in f.state_dict().items()})
    load_jax_variables(q, export_jax_variables(f))


def test_config_dump_round_trips(tmp_path):
    cfg = config.default_config()
    cfg.audio.num_layers = 3
    cfg.tpu.bucket_durations = (1.0, 2.0)
    path = str(tmp_path / "c.yaml")
    cfg.dump(path)
    assert config.Config.load(path).to_dict() == cfg.to_dict()
    assert (jax_config.Config.load(path).to_dict() == cfg.to_dict())


def test_request_batching_matches_jax(rng):
    clips = [rng.uniform(size=(t, 4, 4, 3)).astype(np.float32)
             for t in (3, 7, 5, 12)]
    canon = [request_batching.canonicalize_video(c) for c in clips]
    for got, c in zip(canon, clips):
        np.testing.assert_array_equal(got, jax_batching.canonicalize_video(c))
    bucket = lambda x: 5 if x.shape[0] <= 5 else 10
    groups = request_batching.group_by_bucket(canon, bucket)
    assert groups == jax_batching.group_by_bucket(canon, bucket)
    for size, idxs in groups.items():
        np.testing.assert_array_equal(
            request_batching.padded_chunk(canon, idxs, size, 4, (4, 4, 3),
                                          np.uint8),
            jax_batching.padded_chunk(canon, idxs, size, 4, (4, 4, 3),
                                      np.uint8))


@pytest.mark.parametrize("norm", ["peppa", "kinetics", "imagenet"])
def test_resolve_stats_matches_jax(tmp_path, norm):
    assert (normalization.resolve_stats(norm, str(tmp_path))
            == jax_norm.resolve_stats(norm, str(tmp_path)))
    os.makedirs(tmp_path / "out")
    np.savez(tmp_path / "out" / "stats.npz", video_mean=np.array([.1, .2, .3]),
             video_std=np.array([.4, .5, .6]))
    np.savez(tmp_path / "out" / "kinetics-stats.npz",
             video_mean=np.array([.7, .8, .9]), video_std=np.array([1., 1., 1.]))
    assert (normalization.resolve_stats(norm, str(tmp_path))
            == jax_norm.resolve_stats(norm, str(tmp_path)))


def _tiny_audio_pair():
    from peppa_tpu.models.wav2vec2 import Wav2Vec2Config as JC
    from peppa_tpu.models.wav2vec2 import Wav2Vec2Encoder as JE
    from peppa_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

    kw = dict(embed_dim=16, num_layers=1, num_heads=2, ffn_dim=32,
              pos_conv_kernel=4, pos_conv_groups=2)
    variables = jax.jit(JE(cfg=JC(**kw)).init)(
        jax.random.PRNGKey(0), np.zeros((1, 800), np.float32))
    return jax.tree.map(np.asarray, variables), Wav2Vec2Encoder(
        cfg=Wav2Vec2Config(**kw))


def test_load_refuses_missing_unused_and_misshaped_leaves():
    variables, port = _tiny_audio_pair()
    load_jax_variables(port, variables)  # the full tree loads

    params = variables["params"]["wav2vec2"]
    missing = {"params": {**variables["params"], "wav2vec2": {
        k: v for k, v in params.items() if k != "aux"}}}
    with pytest.raises(ValueError, match="missing wav2vec2.aux.weight"):
        load_jax_variables(port, missing)

    unused = {"params": {**variables["params"], "extra": {
        "bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="unused leaf params/extra/bias"):
        load_jax_variables(port, unused)

    bad = {"params": {**variables["params"], "wav2vec2": {
        **params, "aux": {**params["aux"],
                          "kernel": np.zeros((16, 29), np.float32)}}}}
    with pytest.raises(ValueError, match="wav2vec2.aux.weight: shape"):
        load_jax_variables(port, bad)
