"""`pretrained_loader_from_config` with the pretrained files present
(fairseq wav2vec2, torchvision r2plus1d_18 / r3d_18 / mc3_18 / resnet18)
against the JAX package's loader from the same start, the warning path
without the files, and `widen_midplanes` (pad exact, shrink by importance)
against the JAX package's.  Weights compare exactly; the widened blocks'
outputs within 1e-5 (pad) and 1e-4 (shrink), as tests/test_convert.py
holds the JAX package's.
"""

import logging
import os

import numpy as np
import pytest
import torch

import peppa_tpu.models.convert as J
from peppa_tpu.config import Config as JaxConfig
import peppa_tpu_torch.models.convert as P
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from peppa_tpu_torch.models.video3d import BasicBlock
from test_torch_port_convert import (RAW, _drop_large_files,  # noqa: F401
                                     _fairseq_state, _map, _model,
                                     _nest_stem_bn, _random, _save_fairseq,
                                     _two_threads, assert_trees_equal, base)


# ---------------------------------------------------------- pretrained
@pytest.mark.parametrize("midplanes_multiple", [None, 128])
def test_pretrained_loader_matches_jax(base, tmp_path, midplanes_multiple):
    """fairseq wav2vec2 at audio.path and torchvision r2plus1d_18 at
    data/in/r2plus1d_18.pth: the port's loader gives the JAX loader's tree
    from the same start (with `midplanes_multiple` the Kinetics weights
    are widened or shrunk the same way)."""
    _, _, files = base  # the files' weights; the model starts elsewhere
    vp = files["params"]["video_encoder"]["trunk"]
    sd_video = J.export_video_resnet(
        vp, files["batch_stats"]["video_encoder"]["trunk"], "r2plus1d_18", "")
    sd_audio = _fairseq_state(files["params"]["audio_encoder"]["wav2vec2"])
    data_dir = tmp_path / "data"
    os.makedirs(data_dir / "in")
    torch.save(sd_video, data_dir / "in" / "r2plus1d_18.pth")
    _save_fairseq(str(tmp_path / "w2v.pt"), sd_audio, False)
    raw = {**RAW, "data": {**RAW["data"], "data_dir": str(data_dir)},
           "audio": {**RAW["audio"], "path": str(tmp_path / "w2v.pt")},
           "video": {"midplanes_multiple": midplanes_multiple}}
    cfg, jcfg = Config.from_dict(raw), JaxConfig.from_dict(raw)
    model = _random(PeppaPig(cfg), seed=9)
    start = P.export_jax_variables(model)
    P.pretrained_loader_from_config(cfg)(model)
    got = P.export_jax_variables(model)
    assert_trees_equal(got, J.pretrained_loader_from_config(jcfg)(start))
    if not midplanes_multiple:  # the trunk is the file's, exactly
        assert_trees_equal(got["params"]["video_encoder"]["trunk"], vp)


@pytest.mark.parametrize("version", ["r3d_18", "mc3_18", "static"])
def test_pretrained_video_versions(tmp_path, version):
    """r3d_18 and mc3_18 load as the JAX package loads them; the static
    encoder's resnet18 loads into the port's tree, where the JAX loader
    raises on its own nested stem BatchNorm (module doc)."""
    video = {"static": True} if version == "static" else {"version": version}
    raw = {**RAW, "data": {**RAW["data"], "data_dir": str(tmp_path)},
           "audio": {**RAW["audio"], "pretrained": False}, "video": video}
    cfg, jcfg = Config.from_dict(raw), JaxConfig.from_dict(raw)
    model = _random(PeppaPig(cfg), seed=11)
    start = P.export_jax_variables(model)
    # the file: the start's trunk, every leaf changed
    p = _map(start["params"]["video_encoder"]["trunk"], lambda a: a * 1.5)
    s = _map(start["batch_stats"]["video_encoder"]["trunk"],
             lambda a: a * 1.5 + 0.25)
    sd = (J.export_resnet18(_nest_stem_bn(p), _nest_stem_bn(s), "")
          if version == "static" else J.export_video_resnet(p, s, version, ""))
    os.makedirs(tmp_path / "in")
    torch.save(sd, tmp_path / "in" / f"{version}.pth")
    P.pretrained_loader_from_config(cfg)(model)
    got = P.export_jax_variables(model)
    assert_trees_equal(got["params"]["video_encoder"]["trunk"], p)
    assert_trees_equal(got["batch_stats"]["video_encoder"]["trunk"], s)
    assert_trees_equal(got["params"]["audio_encoder"],
                       start["params"]["audio_encoder"])
    if version == "static":
        with pytest.raises(ValueError, match="stem_bn"):
            J.pretrained_loader_from_config(jcfg)(start)
    else:
        assert_trees_equal(got, J.pretrained_loader_from_config(jcfg)(start))


def test_pretrained_loader_without_files_keeps_init(tmp_path, caplog):
    cfg = Config.from_dict({**RAW, "data": {**RAW["data"],
                                            "data_dir": str(tmp_path)},
                            "audio": {**RAW["audio"],
                                      "path": str(tmp_path / "none.pt")}})
    model, _ = _model(seed=12)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        P.pretrained_loader_from_config(cfg)(model)
    assert caplog.text.count("keeping random init") == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------- widen_midplanes
def _block_tree(block):
    tree = P.export_jax_variables(block)
    return tree["params"], tree["batch_stats"]


def test_widen_midplanes_pad_is_exact():
    """Where the rounded mid width grows (144 -> 256), zero-padding gives
    the same function; the port's trees are the JAX package's."""
    x = torch.rand(1, 64, 4, 10, 10, generator=torch.Generator().manual_seed(0))
    narrow = _random(BasicBlock(64, 64, 1, torch.float32, torch.float32),
                     seed=13)
    p, s = _block_tree(narrow)
    got_p, got_s = P.widen_midplanes({"layer1_block0": p},
                                     {"layer1_block0": s}, 256)
    want_p, want_s = J.widen_midplanes({"layer1_block0": p},
                                       {"layer1_block0": s}, 256)
    assert_trees_equal(got_p, want_p)
    assert_trees_equal(got_s, want_s)
    assert got_p["layer1_block0"]["conv1"]["spatial"]["kernel"].shape[-1] \
        == 256
    wide = BasicBlock(64, 64, 1, torch.float32, torch.float32, 256).eval()
    P.load_jax_variables(wide, {"params": got_p["layer1_block0"],
                                "batch_stats": got_s["layer1_block0"]})
    with torch.no_grad():
        np.testing.assert_allclose(wide(x).numpy(), narrow(x).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_widen_midplanes_shrink_drops_weak_channels():
    """Where it shrinks (144 -> 128), the 16 channels that contribute
    nothing are the ones dropped: the same function within 1e-4; the
    port's trees are the JAX package's."""
    gen = np.random.default_rng(1)
    x = torch.rand(1, 64, 4, 10, 10, generator=torch.Generator().manual_seed(1))
    narrow = _random(BasicBlock(64, 64, 1, torch.float32, torch.float32),
                     seed=14)
    p, s = _block_tree(narrow)
    for conv in ("conv1", "conv2"):
        dead = gen.choice(144, size=16, replace=False)
        p[conv]["spatial"]["kernel"][..., dead] = 0.0
        p[conv]["bn_mid"]["bn"]["bias"][dead] = -1.0
        s[conv]["bn_mid"]["bn"]["mean"][dead] = 0.0
    P.load_jax_variables(narrow, {"params": p, "batch_stats": s})
    got_p, got_s = P.widen_midplanes({"layer1_block0": p},
                                     {"layer1_block0": s}, 128)
    want_p, want_s = J.widen_midplanes({"layer1_block0": p},
                                       {"layer1_block0": s}, 128)
    assert_trees_equal(got_p, want_p)
    assert_trees_equal(got_s, want_s)
    shrunk = BasicBlock(64, 64, 1, torch.float32, torch.float32, 128).eval()
    P.load_jax_variables(shrunk, {"params": got_p["layer1_block0"],
                                  "batch_stats": got_s["layer1_block0"]})
    with torch.no_grad():
        np.testing.assert_allclose(shrunk(x).numpy(), narrow(x).numpy(),
                                   rtol=1e-4, atol=1e-4)
