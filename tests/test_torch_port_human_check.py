"""The human checks (`evaluation/human_check.py`) and `python -m
peppa_tpu_torch.generate_sample_to_check` against the JAX package's:
`export_triplets` over an item cache (the answer key, the anchor WAVs and
the mp4 videos byte for byte), `run_terminal_check`'s accuracy, and
`export_targeted_word` over a minimal-pairs eval set; the sample WAVs
against the root generate_sample_to_check.py's.

Small sizes: tests/test_human_check.py's cache (32x24, 800 Hz) and
tests/test_targeted.py's episode and eval set.
"""

import glob
import json
import os
import random
import shutil

import numpy as np
import pytest
import yaml

import peppa_tpu.evaluation.human_check as JH
import peppa_tpu_torch.evaluation.human_check as H
from peppa_tpu.data.dataset import PeppaPigDataset as JaxDataset
from peppa_tpu_torch.data.dataset import PeppaPigDataset
from test_human_check import build_cache
from test_targeted import make_episode, make_eval_csv
from torch_port_prep_data import tree_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_export_triplets_equals_jax(tmp_path, rng, monkeypatch):
    pytest.importorskip("cv2")
    cache_dir = build_cache(tmp_path, rng)
    monkeypatch.setattr("peppa_tpu.data.dataset.PeppaPigDataset",
                        lambda **kw: JaxDataset(cache_dir=cache_dir))
    monkeypatch.setattr("peppa_tpu_torch.data.dataset.PeppaPigDataset",
                        lambda **kw: PeppaPigDataset(cache_dir=cache_dir))
    out = {}
    for name, module in (("jax", JH), ("port", H)):
        d = str(tmp_path / name)
        key = module.export_triplets(d, n=3, audio_sample_rate=800, seed=5)
        out[name] = (key, tree_bytes(d))
    assert out["port"] == out["jax"]
    key, files = out["port"]
    assert len(key) == 3 and len(files) == 1 + 3 * 3
    assert all(files[f"{i}/left.mp4"] for i in range(3))


def test_run_terminal_check_equals_jax(tmp_path, monkeypatch, capsys):
    key = [dict(index=i, target="lr"[i % 2], target_file=f"t{i}",
                distractor_file=f"d{i}") for i in range(5)]
    with open(tmp_path / "answer_key.json", "w") as f:
        json.dump(key, f)
    answers = ["l", "x", "l", "r", "r", "l"]  # "x" is asked again
    printed = []
    for module in (JH, H):
        it = iter(answers)
        monkeypatch.setattr("builtins.input", lambda *_: next(it))
        acc = module.run_terminal_check(str(tmp_path))
        printed.append((acc, capsys.readouterr().out))
    assert printed[1] == printed[0]
    assert printed[0][0] == 0.6


def test_export_targeted_word_equals_jax(tmp_path):
    pytest.importorskip("cv2")
    out = []
    for name, module in (("jax", JH), ("port", H)):
        root = tmp_path / name
        make_eval_csv(root, make_episode(root, np.random.default_rng(0)))
        data_dir = str(root / "data")
        files = {}
        for word in ("w1a", "w2b", "nope"):
            d = str(root / "check" / word)
            n = module.export_targeted_word(word, d, data_dir=data_dir)
            files[word] = (n, tree_bytes(d))
        out.append(files)
    assert out[1] == out[0]
    assert out[1]["w1a"][0] == 1 and out[1]["nope"][0] == 0
    assert sorted(out[1]["w2b"][1]) == ["w2b_5/anchor.wav",
                                        "w2b_5/negative.mp4",
                                        "w2b_5/positive.mp4"]


def test_sample_to_check_equals_the_root_script(tmp_path, monkeypatch):
    """`sample` with the config of a small tree: the same items written as
    the root script's `sample` writes them, from the same global draws."""
    import importlib.util

    from peppa_tpu_torch import generate_sample_to_check
    from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree

    monkeypatch.chdir(tmp_path)
    make_synthetic_episode_tree("data", target_size=(32, 24),
                                fragment_type="dialog", episodes=(1, 2),
                                clips_per_episode=2, clip_seconds=4.0,
                                sample_rate=800, seed=1)
    config = {"data": {"target_size": [32, 24], "audio_sample_rate": 800,
                       "train": {"batch_size": 4, "duration": 0.8,
                                 "jitter": False, "jitter_sd": None,
                                 "shuffle": True, "force_cache": False}}}
    with open("hparams.yaml", "w") as f:
        yaml.safe_dump(config, f)
    spec = importlib.util.spec_from_file_location(
        "root_sample", os.path.join(ROOT, "generate_sample_to_check.py"))
    root_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_script)
    random.seed(4)
    root_script.sample(k=5, config_file="hparams.yaml", out_dir="want")
    for cache in glob.glob(os.path.join("data", "out", "items-*")):
        shutil.rmtree(cache)  # the port builds its own
    random.seed(4)
    generate_sample_to_check.sample(k=5, config_file="hparams.yaml",
                                    out_dir="got")
    want = tree_bytes("want")
    assert tree_bytes("got") == want and len(want) == 5
