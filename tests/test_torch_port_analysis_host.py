"""The port's host-side analysis layer against the JAX package's, on the
same numpy-made inputs: `preprocess/ipa.py`, `analysis/ols.py`,
`analysis/stats.py`, `analysis/embeddings.py`, `analysis/glove.py`,
`analysis/plotting.py`, and `grsa.probe` on made-up embeddings (its MLPs
are unseeded in both packages: the table's structure and `maj`).

Arrays and DataFrames are equal bit for bit, written CSV and TeX files
byte for byte; the figures are compared by the set of files written, each
non-empty.  No model runs here.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import peppa_tpu.analysis.embeddings as JEMB
import peppa_tpu.analysis.grsa as J
import peppa_tpu.analysis.glove as JGLOVE
import peppa_tpu.analysis.ols as JOLS
import peppa_tpu.analysis.plotting as JPLOT
import peppa_tpu.analysis.stats as JSTATS
import peppa_tpu.preprocess.ipa as JIPA
import peppa_tpu_torch.analysis.embeddings as EMB
import peppa_tpu_torch.analysis.grsa as G
import peppa_tpu_torch.analysis.glove as GLOVE
import peppa_tpu_torch.analysis.ols as OLS
import peppa_tpu_torch.analysis.plotting as PLOT
import peppa_tpu_torch.analysis.stats as STATS
import peppa_tpu_torch.preprocess.ipa as IPA
from peppa_tpu_torch.config import Config
from torch_port_realign_data import write_realign_tree


def assert_same(a, b, path="out"):
    """Equal bit for bit: arrays (NaN where NaN), frames, dicts, lists,
    scalars."""
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True, obj=path)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_exact=True, obj=path)
    elif isinstance(a, (np.ndarray, np.generic)) and not isinstance(a, str):
        assert type(a) is type(b), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b and type(a) is type(b), f"{path}: {a!r} != {b!r}"


def same_files(dir_a, dir_b, compare_bytes):
    """The same relative file set under both; the files whose names end in
    `compare_bytes` equal byte for byte, the others non-empty."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    names = files(dir_a)
    assert names == files(dir_b)
    for name in names:
        a, b = (open(os.path.join(d, name), "rb").read()
                for d in (dir_a, dir_b))
        if name.endswith(compare_bytes):
            assert a == b, name
        else:
            assert a and b, name
    return names


# --------------------------------------------------------------------- ipa
@pytest.mark.parametrize("phone", sorted(JIPA.ARPA_TO_IPA)
                         + ["ah0", "EY1", "k_B", "ow_E", "zz", "X_I"])
def test_arpa2ipa_matches_jax(phone):
    assert IPA.arpa2ipa(phone) == JIPA.arpa2ipa(phone)
    assert IPA.arpa2ipa(phone, "?") == JIPA.arpa2ipa(phone, "?")


def test_phones_to_ipa_matches_jax():
    phones = [{"phone": "hh_B"}, {"phone": "ah_I"}, "l_I", {"phone": "q_E"},
              {"phone": "ow_E"}, {"phone": "ay1"}]
    assert IPA.phones_to_ipa(phones) == JIPA.phones_to_ipa(phones) == "hʌloʊaɪ"
    assert IPA.ARPA_TO_IPA == JIPA.ARPA_TO_IPA


# ------------------------------------------------------------ ols and stats
def _pairs(seed=0, n=120):
    """A pairwise-similarity table like grsa.main's."""
    rng = np.random.default_rng(seed)
    rows = []
    for version in (0, 1):
        for fragment_type in ("dialog", "narration"):
            for multiword in (False, True):
                d1 = rng.uniform(0.1, 2.0, n)
                d2 = rng.uniform(0.1, 2.0, n)
                speaker = rng.integers(0, 2, n).astype(bool).astype(object)
                if fragment_type == "narration":
                    speaker[:] = None
                rows.append(pd.DataFrame(dict(
                    samespeaker=speaker,
                    sameepisode=rng.integers(0, 2, n).astype(bool),
                    sametype=rng.integers(0, 2, n).astype(bool),
                    semsim=np.where(rng.uniform(size=n) < 0.05, 0.0,
                                    rng.normal(size=n)),
                    distance=rng.uniform(0, 1, n),
                    duration1=d1, duration2=d2, durationdiff=abs(d1 - d2),
                    sim_1=rng.normal(size=n), sim_2=rng.normal(size=n),
                    dialog=fragment_type == "dialog", version=version,
                    fragment_type=fragment_type, multiword=multiword)))
    return pd.concat(rows, ignore_index=True)


def _unpaired(seed=1, n=80):
    rng = np.random.default_rng(seed)
    return pd.DataFrame(dict(
        samespeaker=rng.integers(0, 2, n), sameepisode=rng.integers(0, 2, n),
        sametype=rng.integers(0, 2, n), semsim=rng.normal(size=n),
        distance=rng.uniform(0, 1, n), durationdiff=rng.uniform(0, 1, n),
        durationsum=rng.uniform(0, 2, n), sim_1=rng.normal(size=n),
        sim_2=rng.normal(size=n)))


def _records(seed=2, n=24):
    rng = np.random.default_rng(seed)
    return [dict(embedding_2=rng.normal(size=8),
                 embedding_1=rng.normal(size=8),
                 embedding_0=rng.normal(size=8),
                 semsim=rng.normal(size=4), speaker=f"spk{i % 3}",
                 episode=i % 2, duration=float(rng.uniform(0.1, 2)))
            for i in range(n)]


def _ols_data(seed=3, n=60):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    return pd.DataFrame(dict(y=1.0 + 2 * x1 - x2 + rng.normal(size=n),
                             x1=x1, x2=x2))


def _fit(mod):
    res = mod.ols("y ~ x1 + x2", _ols_data())
    return [res.names, res.params, res.bse, res.tvalues, res.pvalues,
            res.df_resid, res.mse_resid, res.rsquared, res.summary_table()]


STATS_CASES = {
    "ols": lambda m, o: _fit(o),
    "ols_no_intercept": lambda m, o: o.ols("y ~ x1", _ols_data(),
                                           drop_intercept=True
                                           ).summary_table(),
    "ols_fit": lambda m, o: o.ols_fit(
        _ols_data()["y"].to_numpy(),
        np.stack([np.ones(60), _ols_data()["x1"].to_numpy()], 1),
        ["a", "b"]).summary_table(),
    "scale": lambda m, o: [m.scale(_pairs()["sim_1"]), m.scale(np.ones(4))],
    "sumcode": lambda m, o: m.sumcode(_pairs()["sametype"]),
    "massage": lambda m, o: m.massage(_pairs().query("dialog")),
    "massage_scaleall": lambda m, o: m.massage(_pairs().query("dialog"),
                                               scaleall=True),
    "standardize": lambda m, o: m.standardize(_unpaired()),
    "rer": lambda m, o: [m.rer(0.8, 0.6), m.rer(2.0, 1.5)],
    "partial_r2": lambda m, o: m.partial_r2(
        "sim_2 ~ semsim + distance + durationsum", m.standardize(_unpaired())),
    "frameit": lambda m, o: m.frameit(np.arange(12.0).reshape(3, 4), "x"),
    "scale_matrix": lambda m, o: m.scale_matrix(
        np.c_[np.random.default_rng(4).normal(size=(9, 3)), np.ones(9)]),
    "ridge": lambda m, o: m.ridge(*(lambda x, y: (x[:20], y[:20], x[20:],
                                                  y[20:]))(
        _unpaired()[["semsim", "distance"]], _unpaired()[["sim_1"]])),
    "ablate": lambda m, o: list(m.ablate(
        {k: m.frameit(np.random.default_rng(5).normal(size=(5, 2)), k)
         for k in ("a", "b", "c")})),
    "backprobe": lambda m, o: m.backprobe(_records()),
    "unpairwise_ols": lambda m, o: m.unpairwise_ols(_unpaired()),
}


@pytest.mark.parametrize("name", sorted(STATS_CASES))
def test_stats_match_jax(name):
    case = STATS_CASES[name]
    assert_same(case(STATS, OLS), case(JSTATS, JOLS))


def test_stats_main_and_tables_match_jax(tmp_path):
    """`main`: coef.csv and both correlation tables byte for byte, the same
    coefficient plots."""
    csv = tmp_path / "pairwise.csv"
    _pairs().to_csv(csv, index=False, na_rep="NA")
    want = JSTATS.main(str(csv), str(tmp_path / "jax"))
    got = STATS.main(str(csv), str(tmp_path / "port"))
    assert_same(got, want)
    names = same_files(tmp_path / "jax", tmp_path / "port", (".csv", ".tex"))
    assert "coef.csv" in names and "rsa_dialog_correlations.csv" in names
    assert sum(n.endswith("_coef.pdf") for n in names) == 4
    assert STATS.cli(["--pairwise_csv", str(csv), "--results_dir",
                      str(tmp_path / "cli")]) == 0
    same_files(tmp_path / "jax", tmp_path / "cli", (".csv", ".tex"))


# ------------------------------------------------------- embeddings, GloVe
def _sentences(seed=6, n=80):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(30)] + ["peppa", "george", "mud"]
    return [[vocab[j] for j in rng.integers(0, len(vocab),
                                            rng.integers(3, 9))]
            for _ in range(n)]


EMB_CASES = {
    "train_ppmi_svd": lambda m: m.train_ppmi_svd(_sentences(), dim=16),
    "train_ppmi_svd_empty": lambda m: m.train_ppmi_svd([["a"], ["b"]]),
    "cooccurrence": lambda m: m.cooccurrence(_sentences(), window=4),
    "train_glove": lambda m: m.train_glove(_sentences(), dim=12, epochs=3,
                                           seed=1),
}


@pytest.mark.parametrize("name", sorted(EMB_CASES))
def test_word_vectors_match_jax(name):
    jmod = {"train_ppmi_svd": JEMB, "train_ppmi_svd_empty": JEMB,
            "cooccurrence": JGLOVE, "train_glove": JGLOVE}[name]
    mod = {JEMB: EMB, JGLOVE: GLOVE}[jmod]
    assert_same(EMB_CASES[name](mod), EMB_CASES[name](jmod))


def test_corpus_vectors_from_a_tree_match_jax(tmp_path):
    """The realign tree's transcripts, the cached PPMI-SVD vectors and the
    corpus GloVe file (written byte for byte the same)."""
    for side in ("jax", "port"):
        write_realign_tree(str(tmp_path / side), seed=0, per_episode=14)
    assert_same(EMB.corpus_sentences(str(tmp_path / "port")),
                JEMB.corpus_sentences(str(tmp_path / "jax")))
    got = EMB.corpus_word_vectors(str(tmp_path / "port"), dim=8)
    want = JEMB.corpus_word_vectors(str(tmp_path / "jax"), dim=8)
    assert got and list(got) == list(want)
    assert_same(got, want)
    # read back from each one's cache, and across
    cache = os.path.join("out", "word_vectors.npz")
    assert_same(EMB.load_vectors(str(tmp_path / "jax" / cache)), want)
    assert_same(EMB.corpus_word_vectors(str(tmp_path / "port"), dim=8), got)
    paths = [m.ensure_corpus_glove(str(tmp_path / side), dim=8, epochs=2)
             for m, side in ((GLOVE, "port"), (JGLOVE, "jax"))]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


# ------------------------------------------------------------------ figures
CONDITIONS = {"base": [0], "pretraining_v": [1], "pretraining_a": [2],
              "pretraining_none": [3], "freeze_wav2vec": [4], "jitter": [5],
              "static": [6]}


def _hparams(version):
    cfg = Config()
    cfg.audio.pretrained = version in (0, 2, 4, 5, 6)
    cfg.video.pretrained = version in (0, 1, 4, 5)
    cfg.video.static = version == 6
    cfg.data.train.jitter = version == 5
    if version == 4:
        cfg.audio.freeze_feature_extractor = True
        cfg.audio.freeze_encoder_layers = 12
    return cfg


def _score_rows(rng, version, root, split_types, n=20, size=7):
    rows = []
    hparams = os.path.join(root, "runs", f"version_{version}", "hparams.yaml")
    os.makedirs(os.path.dirname(hparams), exist_ok=True)
    _hparams(version).dump(hparams)
    for fragment_type in split_types:
        for scrambled in (False, True):
            rec = {k: rng.uniform(size=(n, 11, size)).astype(np.float32)
                   for k in ("recall_fixed", "recall_jitter")}
            rows.append(dict(
                fragment_type=fragment_type, scrambled_video=scrambled,
                triplet_acc=rng.uniform(size=n).astype(np.float32),
                recall_fixed=rec["recall_fixed"],
                recall_jitter=rec["recall_jitter"],
                recall_at_10_fixed=rec["recall_fixed"][:, 10, :],
                recall_at_10_jitter=rec["recall_jitter"][:, 10, :],
                version=version, checkpoint_path=f"v{version}.ckpt",
                hparams_path=hparams))
    return rows


def write_results(root, seed=0):
    """Score files of every condition's run, the test scores of the base
    run, both duration-effect files and conditions.yaml under `root`;
    returns (results_dir, conditions_path)."""
    from peppa_tpu_torch.evaluation.evaluation import add_condition

    rng = np.random.default_rng(seed)
    results = os.path.join(root, "results")
    os.makedirs(results, exist_ok=True)
    for version in range(7):
        rows = _score_rows(rng, version, root, ("dialog", "narration"))
        torch.save(add_condition(rows),
                   os.path.join(results, f"full_scores_v{version}.pt"))
    torch.save(add_condition(_score_rows(rng, 0, root, ("narration",))),
               os.path.join(results, "full_test_scores.pt"))
    durations = np.repeat(np.array([1.0, 2.0, 3.0, 2.5]), 15)
    for name, ids, flags in (("duration_effect", [2, 6], None),
                             ("duration_effect_scramble", [0, 0],
                              [False, True])):
        out = []
        for fragment_type in ("dialog", "narration"):
            result = {"success": [rng.normal(size=len(durations))
                                  .astype(np.float32) for _ in ids],
                      "duration": durations,
                      "fragment_type": fragment_type, "model_ids": ids}
            if flags:
                result["scrambled_video"] = flags
            out.append(result)
        torch.save(out, os.path.join(results, f"{name}.pt"))
    conditions = os.path.join(root, "conditions.yaml")
    with open(conditions, "w") as f:
        yaml.safe_dump(CONDITIONS, f)
    return results, conditions


def test_score_points_and_group_runs_match_jax(tmp_path):
    results, _ = write_results(str(tmp_path))
    rows = torch.load(os.path.join(results, "full_scores_v0.pt"),
                      weights_only=False)
    assert_same(PLOT.score_points(rows), JPLOT.score_points(rows))
    assert_same(PLOT.group_runs(CONDITIONS), JPLOT.group_runs(CONDITIONS))
    assert PLOT.flatten([[1], [2, 3]]) == JPLOT.flatten([[1], [2, 3]])


@pytest.mark.parametrize("figure", ["plots", "recall_at_1_to_n_plot",
                                    "duration_effect_plot",
                                    "duration_effect_plot_scramble"])
def test_figures_match_jax(tmp_path, figure):
    """Each figure function writes the same files as the JAX package's
    from the same result files."""
    results, conditions = write_results(str(tmp_path))
    before = set(os.listdir(results))
    written = {}
    for side, mod in (("jax", JPLOT), ("port", PLOT)):
        out = os.path.join(str(tmp_path), side)
        os.makedirs(out)
        for name in before:
            os.link(os.path.join(results, name), os.path.join(out, name))
        if figure == "plots":
            mod.plots(conditions, out)
        elif figure == "recall_at_1_to_n_plot":
            mod.recall_at_1_to_n_plot(out)
        else:
            mod.duration_effect_plot(conditions, out,
                                     scramble=figure.endswith("scramble"))
        written[side] = out
    names = same_files(written["jax"], written["port"], ".pt")
    assert len(set(names) - before) >= 1


def test_plot_coef_matches_jax(tmp_path):
    table = pd.DataFrame(dict(
        Variable=["Intercept", "semsim", "durationdiff"] * 2,
        Coefficient=[0.1, 0.5, -0.2, 0.0, 0.3, 0.1],
        Lower=[0.0, 0.4, -0.3, -0.1, 0.2, 0.0],
        Upper=[0.2, 0.6, -0.1, 0.1, 0.4, 0.2],
        multiword=False, fragment_type="dialog", version=[0] * 3 + [1] * 3))
    for side, mod in (("jax", JPLOT), ("port", PLOT)):
        mod.plot_coef(table, "dialog", False, str(tmp_path / side))
        mod.plot_coef(table, "narration", True, str(tmp_path / side))
    assert same_files(tmp_path / "jax", tmp_path / "port", ()) == [
        "grsa_dialog_word_coef.pdf"]


# -------------------------------------------------------------- grsa.probe
def _probe_embedder(mod, rng):
    """An Embedder holding made-up embeddings of one stage, and labels."""
    e = mod.Embedder.__new__(mod.Embedder)
    n = {"dialog": 16, "narration": 12}
    e.speaker = {"dialog": [("Peppa", "George", "Daddy", None)[i % 4]
                            for i in range(16)],
                 "narration": ["Narrator"] * 12}
    e.embedding = {f: {"conv": rng.normal(size=(k, 24)).astype(np.float32)}
                   for f, k in n.items()}
    return e


def test_probe_table_structure_matches_jax():
    got = G.probe(_probe_embedder(G, np.random.default_rng(0)))
    want = J.probe(_probe_embedder(J, np.random.default_rng(0)))
    assert list(got.columns) == list(want.columns)
    cols = ["model", "label", "feature", "maj"]
    pd.testing.assert_frame_equal(got[cols], want[cols])
    assert np.isfinite(got["score"]).all() and len(got) == 1
