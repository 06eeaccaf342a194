"""The port's GRSA utterance analyses (`analysis/grsa.py`) against the
JAX package's, on the run directory and realign tree of
tests/torch_port_grsa_run.py (the random inits carried across from the
JAX package):

- `embed_utterances`: the embeddings within 1e-4, the rest equal, the
  random init average-pooled with the given projection;
- `unpairwise_data` fed the same utterances: equal;
- `unpairwise` writes its table and boxplots;
- the time means of the `wav2vec` and `conv` stages include the padding,
  as the JAX package's do;
- `pairwise` of the multiword utterances, which carry no phonemes, needs
  no Levenshtein; the words' does.
"""

import copy
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import peppa_tpu.analysis.grsa as J
from peppa_tpu_torch.analysis import grsa as G
from torch_port_grsa_run import INIT_CALLS, TOL, grsa_run  # noqa: F401

SIMS = ("sim_1", "sim_2")


@pytest.fixture(scope="module")
def utterances(grsa_run):
    kw = dict(fragment_type="dialog", embedder="hashing", projection=True,
              log_dir=grsa_run["log_dir"], data_dir=grsa_run["data_dir"])
    INIT_CALLS.clear()
    got = G.embed_utterances(0, device="cpu", **kw)
    calls = list(INIT_CALLS)
    return got, J.embed_utterances(0, **kw), calls


def test_embed_utterances_matches_jax(utterances, grsa_run):
    got, want, calls = utterances
    cfg = grsa_run["cfg"].audio
    assert calls == [("average", True, cfg.pretrained, 1)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.spelling, g.duration, g.speaker, g.episode) == \
            (w.spelling, w.duration, w.speaker, w.episode)
        assert np.array_equal(g.embedding_t, w.embedding_t)
        for k in ("embedding_1", "embedding_2"):
            np.testing.assert_allclose(getattr(g, k), getattr(w, k),
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("seed", [0, 5])
def test_unpairwise_data_matches_jax(utterances, seed):
    _, want, _ = utterances
    utts = [copy.copy(u) for u in want] * 3  # more pairs
    assert list(G.unpairwise_data(utts, seed=seed)) == \
        list(J.unpairwise_data(utts, seed=seed))


def test_embed_utterances_without_projection(grsa_run):
    """`projection=False`: the average-pooled random init has no projection
    layer, and its embedding is the 28 pooled logits."""
    INIT_CALLS.clear()
    utts = G.embed_utterances(0, "narration", embedder="hashing",
                              log_dir=grsa_run["log_dir"],
                              data_dir=grsa_run["data_dir"], device="cpu")
    assert INIT_CALLS[-1][:2] == ("average", False)
    assert {u.embedding_1.shape for u in utts} == {(28,)}
    assert {u.embedding_2.shape for u in utts} == {(512,)}


def test_time_means_include_padding(grsa_run):
    """A padded batch's `conv` and `context` time means, as `Embedder`
    takes them with `grouped=False`: the JAX package's mean over every
    frame, padding included (`mask_padding=False`), within 1e-4."""
    from peppa_tpu.training.checkpoint import load_best_model as jax_load
    from peppa_tpu_torch.data.audio import audioarray_loader
    from peppa_tpu_torch.training.checkpoint import load_best_model

    vdir = os.path.join(grsa_run["log_dir"], "version_0")
    model, _, _ = load_best_model(vdir, device="cpu")
    jmodel, variables, _, _ = jax_load(vdir)
    rng = np.random.default_rng(0)
    waves = [rng.normal(scale=0.1, size=n).astype(np.float32)
             for n in (11025, 4000)]
    (batch,) = list(audioarray_loader(waves))
    for tap in ("conv", "context"):
        (got,) = G._encode(model, [batch], tap, pool_time=True)
        feats = np.asarray(jmodel.apply(variables, jnp.asarray(batch),
                                        tap=tap,
                                        method=jmodel.encode_audio))
        np.testing.assert_allclose(got, feats.mean(axis=1), rtol=TOL,
                                   atol=TOL)
        valid = feats[1, :12].mean(axis=0)  # 4000 samples: 12 frames
        assert np.abs(got[1] - valid).max() > 10 * TOL


def test_pairwise_needs_levenshtein_only_for_phonemes(grsa_run,
                                                      monkeypatch):
    kw = dict(fragment_type="narration", embedder="hashing",
              log_dir=grsa_run["log_dir"], data_dir=grsa_run["data_dir"],
              device="cpu")
    monkeypatch.setitem(sys.modules, "Levenshtein", None)
    rows = list(G.pairwise(0, multiword=True, **kw))
    assert len(rows) == 4 * 3 // 2
    assert all(r["distance"] is None for r in rows)
    with pytest.raises(ImportError):
        list(G.pairwise(0, multiword=False, **kw))


def test_unpairwise_writes_its_table(grsa_run, tmp_path):
    G.unpairwise(0, embedder="hashing", n_samples=3,
                 log_dir=grsa_run["log_dir"], data_dir=grsa_run["data_dir"],
                 results_dir=str(tmp_path), device="cpu")
    table = pd.read_csv(tmp_path / "unpairwise_coef.csv")
    assert set(table["Dependent Var."]) == set(SIMS)
    assert sorted(table["sample"].unique()) == [0, 1, 2]
    assert os.path.getsize(tmp_path / "unpairwise_boxplots.pdf") > 0
