"""From score files to the paper's tables: the port's `score_means`,
`merge_scores`, `format_tables`, `test_table` and `data_statistics`
(`evaluation/evaluation.py`) and `python -m peppa_tpu_torch.targeted_eval
--plot` against the JAX package's and `evaluation_targeted_triplets.py
--plot`, on one set of result files, one episode tree and one
conditions.yaml: the written CSV and TeX files equal byte for byte, the
same figures written, each non-empty.  No model runs here.
"""

import importlib
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import peppa_tpu.evaluation.evaluation as JE
import peppa_tpu_torch.evaluation.evaluation as E
from peppa_tpu.data.synthetic import \
    make_synthetic_episode_tree as jax_make_tree
from peppa_tpu_torch import targeted_eval
from test_torch_port_analysis_host import assert_same, same_files, \
    write_results
from torch_port_realign_data import write_realign_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _copy(results, dst):
    shutil.copytree(results, dst)
    return str(dst)


def test_score_means_and_pretraining_match_jax(tmp_path):
    results, _ = write_results(str(tmp_path))
    rows = []
    for v in range(7):
        rows += torch.load(os.path.join(results, f"full_scores_v{v}.pt"),
                           weights_only=False)
    assert_same(E.score_means(rows), JE.score_means(rows))
    for row in rows:
        assert E.pretraining(row) == JE.pretraining(row)


@pytest.mark.parametrize("versions", [None, [0, 6, 3]])
def test_merged_tables_match_jax(tmp_path, versions):
    """merge_scores, then format_tables: full_scores.pt, scores.csv and
    scores_{dialog,narration}.tex; test_table: scores_test.tex."""
    results, _ = write_results(str(tmp_path))
    out = {}
    for side, mod in (("jax", JE), ("port", E)):
        out[side] = _copy(results, tmp_path / side)
        mod.merge_scores(versions, out[side])
        mod.format_tables(out[side])
        mod.test_table(out[side])
    names = same_files(out["jax"], out["port"], (".csv", ".tex"))
    assert {"scores.csv", "scores_dialog.tex", "scores_narration.tex",
            "scores_test.tex", "full_scores.pt"} <= set(names)
    merged = [torch.load(os.path.join(out[s], "full_scores.pt"),
                         weights_only=False) for s in ("port", "jax")]
    assert_same(*merged)
    assert len(merged[0]) == 4 * (len(versions) if versions else 7)


def test_data_statistics_match_jax(tmp_path):
    """Over one episode tree (dialog train and val, narration val and
    test; 32x24, 800 Hz), and from given durations."""
    data_dir = str(tmp_path / "data")
    for fragment, episodes in (("dialog", (1, 197)), ("narration", (2, 105))):
        jax_make_tree(data_dir, target_size=(32, 24), fragment_type=fragment,
                      episodes=episodes, clips_per_episode=2,
                      clip_seconds=7.0, sample_rate=800)
    for side, mod in (("jax", JE), ("port", E)):
        mod.data_statistics(str(tmp_path / side), data_dir=data_dir,
                            target_size=(32, 24))
        mod.data_statistics(
            str(tmp_path / f"{side}_fn"),
            durations_fn=lambda split, fragment: np.arange(
                len(split) + len(fragment), dtype=np.float64) * 2.3)
    for a, b in (("jax", "port"), ("jax_fn", "port_fn")):
        assert same_files(tmp_path / a, tmp_path / b, (".csv", ".tex")) == [
            "data_statistics.csv", "data_statistics.tex"]
    table = pd.read_csv(tmp_path / "port" / "data_statistics.csv")
    assert table["# Clips"].tolist() == [6, 6, 6, 6]


# --------------------------------------------------------- targeted --plot
WORDS = {"ADJ": ("big", "muddy"), "VERB": ("jump", "run", "dig"),
         "NOUN": ("pig", "house", "puddle")}
TARGETED_CONDITIONS = {"base": [0], "pretraining_a": [1], "static": [2]}


def _targeted_results(results_dir, seed=0):
    """minimal_pairs_scores.csv of versions 0 and 1, as the JAX CLI writes
    them (its index column first), with words seen often enough for the
    per-word plots."""
    rng = np.random.default_rng(seed)
    for version in (0, 1):
        rows = []
        for pos, words in WORDS.items():
            for scrambled in (False, True):
                for i in range(36):
                    target = words[i % len(words)]
                    distractor = words[(i + 1) % len(words)]
                    start = float(np.round(rng.uniform(0, 5), 3))
                    n_tok = int(rng.integers(1, 5))
                    rows.append(dict(
                        id=i, episode_filepath=f"ep/{i % 3}.npz",
                        clipStart=start,
                        clipEnd=float(np.round(start + rng.uniform(0.3, 2),
                                               3)),
                        transcript=" ".join([target] * n_tok),
                        tokenized=str([target] * n_tok),
                        target_word=target, distractor_word=distractor,
                        id_counterexample=i ^ 1,
                        result=float(rng.uniform() < 0.6), pos=pos,
                        fragment="narration", scrambled_video=scrambled))
        path = os.path.join(results_dir, f"version_{version}",
                            "minimal_pairs_scores.csv")
        os.makedirs(os.path.dirname(path))
        pd.DataFrame.from_records(rows).to_csv(path)


def test_targeted_plot_matches_the_jax_cli(tmp_path, monkeypatch):
    """One results tree, conditions.yaml and realign tree (dialog train
    episodes for the word frequencies) in a directory for each CLI: the
    same minimal_pairs.{csv,tex} bytes and the same figures."""
    base = tmp_path / "base"
    _targeted_results(str(base / "results" / "targeted_triplets"))
    write_realign_tree(str(base / "data"), seed=1, per_episode=6,
                       episodes={"dialog": (3, 4, 197)})
    with open(base / "conditions.yaml", "w") as f:
        yaml.safe_dump(TARGETED_CONDITIONS, f)
    jax_dir, port_dir = (_copy(base, tmp_path / s) for s in ("jax", "port"))

    monkeypatch.chdir(jax_dir)
    monkeypatch.setattr(sys, "argv", ["evaluation_targeted_triplets.py",
                                      "--plot", "--versions", "0", "1"])
    monkeypatch.syspath_prepend(ROOT)
    importlib.import_module("evaluation_targeted_triplets").main()

    monkeypatch.chdir(tmp_path)
    assert targeted_eval.main([
        "--plot", "--versions", "0", "1", "--results_dir",
        os.path.join(port_dir, "results", "targeted_triplets"),
        "--data_dir", os.path.join(port_dir, "data"), "--conditions",
        os.path.join(port_dir, "conditions.yaml")]) == 0
    names = same_files(os.path.join(jax_dir, "results"),
                       os.path.join(port_dir, "results"), (".csv", ".tex"))
    figures = {n for n in names if n.endswith((".pdf", ".png"))}
    assert {os.path.join("targeted_triplets", "condition_base", f)
            for f in ("acc_per_word_NOUN.pdf", "acc_per_word_VERB.pdf",
                      "acc_per_duration.pdf", "acc_per_num_tokens.pdf")
            } <= figures
    assert os.path.join("targeted_triplets", "version_0",
                        "correlation_frequency_acc.png") in figures
    table = pd.read_csv(os.path.join(port_dir, "results",
                                     "minimal_pairs.csv"))
    assert len(table) == 2 * len(WORDS) * 2
    assert set(table["condition"]) == {"base", "pretraining_a"}


def test_targeted_bootstrap_helpers_match_the_jax_cli(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    ett = importlib.import_module("evaluation_targeted_triplets")
    values = np.random.default_rng(3).uniform(size=17)
    assert list(targeted_eval.get_bootstrapped_scores(values, 7)) == \
        list(ett.get_bootstrapped_scores(values, 7))
    frame = pd.DataFrame(dict(result=values, word=list("abcabcabcabcabcab")))
    assert_same(targeted_eval.bootstrap_scores_for_column(frame, "word"),
                ett.bootstrap_scores_for_column(frame, "word"))
