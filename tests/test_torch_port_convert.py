"""The port's reference-weight converters and exporters
(`peppa_tpu_torch/models/convert.py`) against the JAX package's, leaf for
leaf, on state dicts made by the JAX package's own exporters and by the
reference-style torch twin (`tests/torch_twin.py`); the two merge rules;
(`tests/test_torch_port_pretrained.py` has the pretrained files).

Weights compare exactly, except the weight-norm kernel g * v / ||v||, which
is rebuilt and held at 1e-6 relative.  No JAX model is initialised: every
tree starts from the port's seeded init, exported with
`export_jax_variables`, and both packages' converters and merges run on
the same numpy trees.  Small sizes: wav2vec2-base with 2 of its 12 layers,
the video towers at full width.
"""

import argparse
import logging
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import peppa_tpu.models.convert as J
from peppa_tpu.config import Config as JaxConfig
import peppa_tpu_torch.models.convert as P
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.dual_encoder import PeppaPig, _init_parameters
from peppa_tpu_torch.models.layers import BatchNorm
from peppa_tpu_torch.models.resnet2d import ImageEncoder
from peppa_tpu_torch.models.video3d import R3DEncoder
from torch_twin import (KINETICS_MEAN, KINETICS_STD, W2V_CONV_LAYERS,
                        TorchPeppaPig, randomize, ref_hparams,
                        save_lightning_ckpt)

RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}}}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def remove_large_files(root, limit=1 << 20):
    """Delete the files over `limit` bytes under `root`: these tests write
    checkpoints of 0.2-0.5 GB, and pytest keeps the temporary directories
    of its last runs."""
    for p in Path(root).rglob("*"):
        if p.is_file() and p.stat().st_size > limit:
            p.unlink()


@pytest.fixture(autouse=True)
def _drop_large_files(request):
    yield
    tmp = request.node.funcargs.get("tmp_path")
    if tmp is not None:
        remove_large_files(tmp)


def _random(module, seed=0):
    """Seeded init, then BatchNorm parameters and statistics away from
    their init, so that every leaf carries information."""
    gen = torch.Generator().manual_seed(seed)
    _init_parameters(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    return module.eval()


def _model(seed=0, **video):
    cfg = Config.from_dict({**RAW, "video": video})
    return _random(PeppaPig(cfg), seed), cfg


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unnest_stem_bn(tree):
    """The JAX package's resnet18 tree with stem_bn/bn flattened to the
    model's stem_bn (module doc of the port's convert.py)."""
    out = dict(tree)
    out["stem_bn"] = tree["stem_bn"]["bn"]
    return out


def _nest_stem_bn(tree):
    out = dict(tree)
    out["stem_bn"] = {"bn": tree["stem_bn"]}
    return out


# ------------------------------------------------------------- video trunks
@pytest.mark.parametrize("version", ["r2plus1d_18", "r3d_18", "mc3_18"])
def test_video_resnet_converters_match_jax(version):
    enc = _random(R3DEncoder(version=version), seed=1)
    tree = P.export_jax_variables(enc)
    p, s = tree["params"]["trunk"], tree["batch_stats"]["trunk"]
    sd = J.export_video_resnet(p, s, version, "")
    got_p, got_s = P.convert_video_resnet(sd, version)
    want_p, want_s = J.convert_video_resnet(sd, version)
    assert_trees_equal(got_p, want_p)
    assert_trees_equal(got_s, want_s)
    assert_trees_equal(got_p, p)  # the round trip is exact
    assert_trees_equal(got_s, s)
    assert_state_dicts_equal(P.export_video_resnet(p, s, version, "x."),
                             J.export_video_resnet(p, s, version, "x."))


def test_resnet18_converter_matches_jax_and_fits_the_model():
    enc = _random(ImageEncoder(pooling="attention"), seed=2)
    tree = P.export_jax_variables(enc)
    p, s = tree["params"]["trunk"], tree["batch_stats"]["trunk"]
    assert set(p["stem_bn"]) == {"scale", "bias"}  # flax BatchNorm, no "bn"
    sd = J.export_resnet18(_nest_stem_bn(p), _nest_stem_bn(s), "")
    got_p, got_s = P.convert_resnet18(sd)
    want_p, want_s = J.convert_resnet18(sd)
    assert_trees_equal(got_p, _unnest_stem_bn(want_p))
    assert_trees_equal(got_s, _unnest_stem_bn(want_s))
    assert_trees_equal(got_p, p)
    assert_trees_equal(got_s, s)
    assert_state_dicts_equal(P.export_resnet18(p, s, ""), sd)


# ---------------------------------------------------------------- wav2vec2
def _fairseq_state(trunk):
    """The fairseq names of a wav2vec2 trunk tree (the inverse of
    `convert_wav2vec2_fairseq`), as torch tensors."""
    t = lambda a: torch.tensor(np.asarray(a))
    lin = lambda k: t(np.asarray(k).T)
    sd = {}
    fe = trunk["feature_extractor"]
    i = 0
    while f"conv{i}" in fe:
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = t(np.transpose(
            fe[f"conv{i}"]["kernel"], (2, 1, 0)))
        i += 1
    sd["feature_extractor.conv_layers.0.2.weight"] = t(
        fe["group_norm"]["scale"])
    sd["feature_extractor.conv_layers.0.2.bias"] = t(fe["group_norm"]["bias"])
    sd["layer_norm.weight"] = t(trunk["proj_ln"]["scale"])
    sd["layer_norm.bias"] = t(trunk["proj_ln"]["bias"])
    sd["post_extract_proj.weight"] = lin(trunk["proj"]["kernel"])
    sd["post_extract_proj.bias"] = t(trunk["proj"]["bias"])
    pc = trunk["pos_conv"]
    sd["encoder.pos_conv.0.weight_v"] = t(np.transpose(pc["pos_conv_v"],
                                                       (2, 1, 0)))
    sd["encoder.pos_conv.0.weight_g"] = t(np.transpose(pc["pos_conv_g"],
                                                       (2, 1, 0)))
    sd["encoder.pos_conv.0.bias"] = t(pc["pos_conv_bias"])
    sd["encoder.layer_norm.weight"] = t(trunk["encoder_ln"]["scale"])
    sd["encoder.layer_norm.bias"] = t(trunk["encoder_ln"]["bias"])
    i = 0
    while f"layer{i}" in trunk:
        lp, pre = trunk[f"layer{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{name}.weight"] = lin(
                lp["attention"][name]["kernel"])
            sd[f"{pre}.self_attn.{name}.bias"] = t(
                lp["attention"][name]["bias"])
        for src, dst in (("ln1", "self_attn_layer_norm"),
                         ("ln2", "final_layer_norm")):
            sd[f"{pre}.{dst}.weight"] = t(lp[src]["scale"])
            sd[f"{pre}.{dst}.bias"] = t(lp[src]["bias"])
        sd[f"{pre}.fc1.weight"] = lin(lp["ffn_in"]["kernel"])
        sd[f"{pre}.fc1.bias"] = t(lp["ffn_in"]["bias"])
        sd[f"{pre}.fc2.weight"] = lin(lp["ffn_out"]["kernel"])
        sd[f"{pre}.fc2.bias"] = t(lp["ffn_out"]["bias"])
        i += 1
    sd["encoder.mask_emb"] = torch.zeros(768)  # fairseq keeps it; unused
    return sd


def _save_fairseq(path, state, with_foreign_objects):
    """A fairseq blob: {"model": ..., "args"/"cfg": ...}.  With
    `with_foreign_objects` it pickles an argparse Namespace and an object
    of an `omegaconf` module that the loader's process does not have."""
    blob = {"model": state}
    created = []
    if with_foreign_objects:
        if "omegaconf" not in sys.modules:
            sys.modules["omegaconf"] = types.ModuleType("omegaconf")
            created.append("omegaconf")

        class DictConfig(dict):
            pass

        DictConfig.__module__ = "omegaconf"
        DictConfig.__qualname__ = "DictConfig"
        sys.modules["omegaconf"].DictConfig = DictConfig
        blob["cfg"] = DictConfig(model={"_name": "wav2vec2"})
        blob["args"] = argparse.Namespace(arch="wav2vec2")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(blob, path)
    finally:
        for name in created:
            sys.modules.pop(name, None)


@pytest.fixture(scope="module")
def base():
    """The port's seeded base model (r2plus1d_18, 2 audio layers) and its
    JAX-layout tree."""
    torch.set_num_threads(2)
    model, cfg = _model(seed=3)
    return model, cfg, P.export_jax_variables(model)


def test_wav2vec2_fairseq_converter_matches_jax(base, tmp_path):
    _, _, tree = base
    trunk = tree["params"]["audio_encoder"]["wav2vec2"]
    sd = _fairseq_state(trunk)
    got, want = P.convert_wav2vec2_fairseq(sd), J.convert_wav2vec2_fairseq(sd)
    assert_trees_equal(got, want)
    assert_trees_equal(got, {k: v for k, v in trunk.items() if k != "aux"})
    # the loader: the port reads a blob with foreign objects as well
    plain, foreign = str(tmp_path / "plain.pt"), str(tmp_path / "foreign.pt")
    _save_fairseq(plain, sd, False)
    _save_fairseq(foreign, sd, True)
    start = P.export_jax_variables(_model(seed=4)[0])
    want_tree = J.load_wav2vec2_pretrained(plain, start)
    assert_trees_equal(P.load_wav2vec2_pretrained(plain, start), want_tree)
    assert_trees_equal(P.load_wav2vec2_pretrained(foreign, start), want_tree)
    with pytest.raises(Exception):  # the JAX package's plain torch.load
        J.load_wav2vec2_pretrained(foreign, start)


def test_torchaudio_converter_and_weight_norm_match_the_twin():
    """A reference-style torch PeppaPig (torchaudio and torchvision names,
    legacy weight norm): both packages' `convert_peppa_state_dict` give the
    same tree; the port's rebuilt positional kernel g * v / ||v|| is the
    exact one (float64, from the twin's g and v) within 1e-6 relative."""
    twin = randomize(TorchPeppaPig(W2V_CONV_LAYERS, mean=KINETICS_MEAN,
                                   std=KINETICS_STD, n_layers=2)).eval()
    sd = twin.state_dict()
    raw = ref_hparams()
    raw["audio"]["num_layers"] = 2
    got = P.convert_peppa_state_dict(sd, Config.from_dict(raw))
    want = J.convert_peppa_state_dict(sd, JaxConfig.from_dict(raw))
    assert_trees_equal(got[0], want[0])
    assert_trees_equal(got[1], want[1])
    port = PeppaPig(Config.from_dict(raw))
    P.load_jax_variables(port, {"params": got[0], "batch_stats": got[1]})
    pc = port.audio_encoder.wav2vec2.pos_conv
    v = pc.pos_conv_v.detach()
    kernel = (pc.pos_conv_g * v / torch.sqrt(
        torch.sum(v * v, dim=(1, 2), keepdim=True) + 1e-12)).permute(2, 1, 0)
    conv = twin.audio_encoder.audio.encoder.transformer.pos_conv_embed.conv
    with torch.no_grad():
        conv(torch.zeros(1, 768, 4))  # the weight-norm hook sets .weight
    g64, v64 = conv.weight_g.double(), conv.weight_v.double()
    exact = g64 * v64 / torch.sqrt(torch.sum(v64 * v64, dim=(0, 1),
                                             keepdim=True))
    # held to the exact kernel (torch's own weight norm, the twin's
    # `.weight`, is 1.6e-6 off it here in float32)
    rel = ((kernel.detach().double() - exact).abs().max()
           / exact.abs().max()).item()
    assert rel <= 1e-6, rel


# ------------------------------------------------- Lightning checkpoints
def test_load_peppa_checkpoint_round_trip(base, tmp_path, monkeypatch):
    """The JAX package's `save_reference_checkpoint` of the port's tree
    loads back into the port exactly; the port's writer makes the same
    blob."""
    model, cfg, tree = base
    jcfg = JaxConfig.from_dict(RAW)
    path = str(tmp_path / "ref.ckpt")
    J.save_reference_checkpoint(path, tree, jcfg, epoch=2, global_step=40,
                                monitor="valnarr_triplet", score=0.75)
    loaded, got_cfg, meta = P.load_peppa_checkpoint(path, cfg, device="cpu")
    assert meta == {"epoch": 2, "global_step": 40}
    assert_trees_equal(P.export_jax_variables(loaded), tree)
    mine = str(tmp_path / "mine.ckpt")
    P.save_reference_checkpoint(mine, tree, cfg, epoch=2, global_step=40,
                                monitor="valnarr_triplet", score=0.75)
    a, b = P.load_torch_checkpoint(path), P.load_torch_checkpoint(mine)
    assert_state_dicts_equal(b["state_dict"], a["state_dict"])
    assert b["hyper_parameters"] == a["hyper_parameters"]
    assert {k: b[k] for k in ("epoch", "global_step")} \
        == {k: a[k] for k in ("epoch", "global_step")}
    (cb_a,), (cb_b,) = a["callbacks"].values(), b["callbacks"].values()
    assert cb_a["monitor"] == cb_b["monitor"]
    assert float(cb_a["best_model_score"]) == float(cb_b["best_model_score"])
    assert "pytorch_lightning" not in sys.modules
    # with no config given, the embedded hyper_parameters give it (the
    # reference's keys only: 12 layers, of which the file holds 2; the
    # seeded init of the other 10 is skipped here)
    import peppa_tpu_torch.models.dual_encoder as dual_encoder

    monkeypatch.setattr(dual_encoder, "init_model",
                        lambda config, seed=0, device=None: PeppaPig(config))
    loaded, embedded, _ = P.load_peppa_checkpoint(mine, device="cpu")
    assert embedded.audio.num_layers is None
    assert embedded.data.target_size == cfg.data.target_size
    got = P.export_jax_variables(loaded)
    assert_trees_equal(got["params"]["video_encoder"],
                       tree["params"]["video_encoder"])
    assert_trees_equal(got["params"]["audio_encoder"]["wav2vec2"]["layer1"],
                       tree["params"]["audio_encoder"]["wav2vec2"]["layer1"])


def test_merge_rules_match_jax(tmp_path, caplog):
    """The Lightning import's recursive intersecting merge: leaves the
    model lacks are dropped and logged (here the second transformer layer
    of a twin with two, into a model with one), a shape mismatch raises;
    as the JAX package's `_merge_intersect`."""
    twin = randomize(TorchPeppaPig(W2V_CONV_LAYERS, mean=KINETICS_MEAN,
                                   std=KINETICS_STD, n_layers=2), seed=5)
    raw = ref_hparams()
    raw["audio"]["num_layers"] = 1
    raw["data"] = RAW["data"]
    cfg = Config.from_dict(raw)
    model = _random(PeppaPig(cfg), seed=6)
    start = P.export_jax_variables(model)
    conv = P.convert_peppa_state_dict(twin.state_dict(), cfg)
    got = P._deep_copy_tree(start)
    want = J._deep_copy_tree(start)
    dropped_p, dropped_j = [], []
    for coll, i in (("params", 0), ("batch_stats", 1)):
        P._merge_intersect(got[coll], conv[i], coll, dropped_p)
        J._merge_intersect(want[coll], conv[i], coll, dropped_j)
    assert_trees_equal(got, want)
    assert dropped_p == dropped_j
    assert dropped_p == ["params/audio_encoder/wav2vec2/layer1"]
    with pytest.raises(ValueError, match="Shape mismatch"):
        bad = {"audio_encoder": {"project": {"bias": np.zeros(3)}}}
        P._merge_intersect(P._deep_copy_tree(start["params"]), bad, "p", [])
    # and end to end through a Lightning file of the twin
    path = str(tmp_path / "twin.ckpt")
    save_lightning_ckpt(path, twin.state_dict(), raw, 0.5, "valnarr_triplet")
    with caplog.at_level(logging.INFO):
        loaded, _, _ = P.load_peppa_checkpoint(path, cfg, device="cpu")
    assert "not in the model tree" in caplog.text
    assert_trees_equal(P.export_jax_variables(loaded), want)
