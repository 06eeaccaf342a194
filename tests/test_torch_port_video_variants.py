"""The R3D-18 and MC3-18 towers (`models/video3d.py`) and the static
per-frame ResNet-18 encoder (`models/resnet2d.py`, attention and average
pooling) against the JAX package's modules on the same weights, in eval
mode and in training mode (batch statistics, and the
running statistics they update).  The weights are the port's seeded init
with BatchNorm moved off its init, carried into the JAX modules by
`export_jax_variables`, and `load_jax_variables` takes them back exactly.

Small sizes: 32x24 frames, 9 frames with frame lengths (9, 5), float32.
Embeddings and updated statistics within 1e-5 (the towers' 1e-4 holds
with room).
"""

import jax
import numpy as np
import pytest
import torch

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.convert import (export_jax_variables,
                                            load_jax_variables)
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from test_torch_port_convert import (_random, _two_threads,  # noqa: F401
                                     assert_trees_equal)

RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 1, "full": False},
       "training": {"trainer_args": {"precision": 32}}}
TOL = 1e-5
VARIANTS = {"r3d_18": {"version": "r3d_18"},
            "mc3_18": {"version": "mc3_18"},
            "static_attention": {"static": True},
            "static_average": {"static": True, "pooling": "average"}}


def _inputs():
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, size=(2, 9, 24, 32, 3), dtype=np.uint8)
    return video, np.array([9, 5], np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_video_variant_matches_jax(variant):
    raw = {**RAW, "video": VARIANTS[variant]}
    port = _random(PeppaPig(Config.from_dict(raw)), seed=1)
    variables = export_jax_variables(port)
    again = PeppaPig(Config.from_dict(raw))
    load_jax_variables(again, variables)
    assert_trees_equal(export_jax_variables(again), variables)
    jm = JaxPeppaPig(JaxConfig.from_dict(raw))
    video, lengths = _inputs()
    want = np.asarray(jm.apply(variables, video, lengths,
                               method=jm.encode_video))
    with torch.no_grad():
        got = port.encode_video(torch.from_numpy(video),
                                torch.from_numpy(lengths)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    # training mode: batch statistics, and the running ones updated
    want_t, updated = jm.apply(variables, video, lengths, True,
                               method=jm.encode_video,
                               mutable=["batch_stats"])
    with torch.no_grad():
        got_t = port.encode_video(torch.from_numpy(video),
                                  torch.from_numpy(lengths),
                                  train=True).numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=TOL,
                               atol=TOL)
    got_stats = export_jax_variables(port)["batch_stats"]
    want_stats = jax.tree.map(np.asarray, updated["batch_stats"])
    worst = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(a - b).max()), got_stats, want_stats)))
    assert worst <= TOL, worst


def test_temporal_stride_and_names():
    """mc3_18 keeps the frame count (no temporal stride), r3d_18 divides it
    by 8; the static encoder's pool and flat BatchNorms carry the JAX
    package's names."""
    video, lengths = _inputs()
    for version, frames in (("r3d_18", 2), ("mc3_18", 9)):
        port = PeppaPig(Config.from_dict({**RAW,
                                          "video": {"version": version}}))
        _random(port, seed=2)
        assert port.video_encoder.t_stride == (1 if version == "mc3_18"
                                               else 8)
        with torch.no_grad():
            feats = port.encode_video(torch.from_numpy(video), tap="features")
        assert feats.shape[1] == frames
    static = PeppaPig(Config.from_dict({**RAW, "video": {"static": True}}))
    tree = export_jax_variables(_random(static, seed=3))["params"]
    assert set(tree["video_encoder"]) == {"trunk", "pool", "project"}
    assert set(tree["video_encoder"]["trunk"]["layer2_block0"]["bn1"]) \
        == {"scale", "bias"}
