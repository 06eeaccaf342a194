"""The port's GRSA analysis (`analysis/grsa.py`) against the JAX package's:
the data layer, the text embedders, `Embedder` and the analyses fed from
it, on one JAX-format run directory over a realign tree of 44.1 kHz WAV
utterances (tests/torch_port_grsa_run.py: the random inits carried across
from the JAX package).

- `realign_paths`, `UttData` words and multiwords (audio included) and the
  hashing, corpus, corpus-GloVe and GloVe-file text embedders: equal.
- `Embedder.embed`'s five stages: within 1e-4 (float32, CPU); the
  average-pooled stage against the JAX modules run op by op, whose pool
  bins are the reference's (`jax.jit` moves some, ROADMAP C.7).
- `word_type`, `vanilla_rsa` and `prepare_probe` fed the same
  embeddings: within 1e-4.

(`pairwise`, `embed_utterances`, `unpairwise_data`, `probe` and `main` are
in tests/test_torch_port_grsa_pairs.py.)
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peppa_tpu.analysis.grsa as J
from peppa_tpu_torch.analysis import grsa as G
from torch_port_grsa_run import INIT_CALLS, TOL, grsa_run  # noqa: F401
from torch_port_realign_data import write_realign_tree

TEXTS = ["peppa", "muddy puddle", "George jumps in the puddle", "",
         "house, big! run?"]


def _utt_fields(u):
    return (u.spelling, u.duration, u.speaker, u.phonemes, u.episode)


def test_realign_paths_match_jax(grsa_run):
    for fragment_type in ("dialog", "narration"):
        got = G.realign_paths(fragment_type, grsa_run["data_dir"])
        assert got == J.realign_paths(fragment_type, grsa_run["data_dir"])
        assert len(got[0]) == 4 and all(os.path.exists(p) for p in got[0])


@pytest.mark.parametrize("multiword", [False, True])
@pytest.mark.parametrize("fragment_type", ["dialog", "narration"])
def test_uttdata_matches_jax(grsa_run, fragment_type, multiword):
    """Words (or whole utterances), their 44.1 kHz audio and their text
    embeddings; the phonemes through the port's ARPAbet table."""
    paths = J.realign_paths(fragment_type, grsa_run["data_dir"])
    embed = J.hashing_text_embedder()
    want = list(J.UttData(*paths, multiword=multiword).utterances(
        read_audio=True, embed=embed))
    got = list(G.UttData(*paths, multiword=multiword).utterances(
        read_audio=True, embed=embed))
    assert len(got) == len(want) == (4 if multiword else 8)
    for g, w in zip(got, want):
        assert _utt_fields(g) == _utt_fields(w)
        assert g.audio.dtype == np.float32
        assert np.array_equal(g.audio, w.audio)
        assert np.array_equal(g.embedding_t, w.embedding_t)
    if not multiword:
        assert all(g.phonemes for g in got)
        assert G.normalized_distance(got[0].phonemes, got[1].phonemes) == \
            J.normalized_distance(want[0].phonemes, want[1].phonemes)
    assert {len(g.audio) for g in got} == (
        {33075} if multiword else {11025, 22050})  # 0.75, 0.25, 0.5 s


def test_speaker_helpers_match_jax(tmp_path):
    data = {"narrator_splits": [{"context": {
        "subtitles": [{"begin": "0:00:01", "end": "0:00:03", "speaker": "P"},
                      {"begin": "0:00:04", "end": "0:00:05"}],
        "tokenized": [{"begin": "0:00:01.5", "end": "0:00:02"},
                      {"begin": "0:00:04.2", "end": "0:00:04.8"}]}}]}
    for mod in (G, J):
        d = {"narrator_splits": [{"context": {
            k: [dict(x) for x in v] for k, v in
            data["narrator_splits"][0]["context"].items()}}]}
        mod.speakerize_tokens(d["narrator_splits"][0]["context"])
        d_tok = d["narrator_splits"][0]["context"]["tokenized"]
        mod.speakerize(d)
        if mod is G:
            got = (d, d_tok)
        else:
            assert (d, d_tok) == got
    assert got[1][0]["speaker"] == "P" and "speaker" not in got[1][1]
    ep = tmp_path / "in" / "peppa" / "episodes"
    ep.mkdir(parents=True)
    (ep / "ep_3.json").write_text(json.dumps(data))
    G.as_yaml([3], str(tmp_path))
    out = (tmp_path / "out" / "speaker_id" / "ep_3.yaml").read_text()
    J.as_yaml([3], str(tmp_path))
    assert (tmp_path / "out" / "speaker_id" / "ep_3.yaml").read_text() == out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A realign tree of 56 transcripts (enough for the corpus vectors),
    one for each package (each caches its vectors in its tree), and a
    GloVe text file."""
    root = tmp_path_factory.mktemp("corpus")
    for side in ("jax", "port"):
        write_realign_tree(str(root / side), seed=2, per_episode=14)
    glove = root / "glove.txt"
    rng = np.random.default_rng(0)
    glove.write_text("".join(
        f"{w} " + " ".join(f"{x:.5f}" for x in rng.normal(size=6)) + "\n"
        for w in ("peppa", "muddy", "puddle", "george", "house", "big")))
    return root


@pytest.mark.parametrize("kind", ["hashing", "corpus", "glove_corpus",
                                  "auto", "glove_file"])
def test_text_embedders_match_jax(corpus, kind):
    if kind == "hashing":
        pairs = [(G.hashing_text_embedder(), J.hashing_text_embedder())]
    elif kind == "glove_file":
        path = str(corpus / "glove.txt")
        pairs = [(G.glove_text_embedder(path), J.glove_text_embedder(path))]
    else:
        pairs = [(G.make_text_embedder(kind, str(corpus / "port")),
                  J.make_text_embedder(kind, str(corpus / "jax")))]
    for got, want in pairs:
        for text in TEXTS:
            g, w = np.asarray(got(text)), np.asarray(want(text))
            assert g.dtype == w.dtype and np.array_equal(g, w), text
    if kind == "corpus":
        assert os.path.exists(corpus / "port" / "out" / "word_vectors.npz")


def test_missing_text_models_fall_through_as_in_jax(tmp_path, monkeypatch):
    """Without a sentence-transformers snapshot, GloVe files or a corpus,
    "auto" falls through to hashing in both packages, and the named
    embedders raise alike."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert G._st_model_cached() is J._st_model_cached() is False
    assert G.sentence_transformer_embedder() is None
    assert G.glove_text_embedder(data_dir=str(tmp_path)) is None
    for kind in ("st", "glove", "corpus"):
        for mod in (G, J):
            with pytest.raises(RuntimeError):
                mod.make_text_embedder(kind, str(tmp_path))
    got = G.make_text_embedder("auto", str(tmp_path))("peppa pig")
    assert np.array_equal(got, J.hashing_text_embedder()("peppa pig"))


@pytest.fixture(scope="module")
def embedders(grsa_run):
    """Both packages' `Embedder` of version 0, audio loaded and embedded."""
    args = (0, grsa_run["log_dir"], grsa_run["data_dir"])
    want, got = J.Embedder(*args), G.Embedder(*args)
    want.load_audio()
    got.load_audio()
    want.embed()
    INIT_CALLS.clear()
    got.embed(device="cpu")
    got.init_calls = list(INIT_CALLS)
    return got, want


def test_embedder_inits_as_the_jax_package(embedders, grsa_run):
    """The untrained model: the run's config with `audio.pretrained`
    false, seed 1; the project stage's: `audio.pooling: average`, seed 2
    (grsa.py:416-422)."""
    got, _ = embedders
    cfg = grsa_run["cfg"].audio
    assert got.init_calls == [("attention", cfg.project, False, 1),
                              ("average", cfg.project, cfg.pretrained, 2)]


def jax_unjitted_project(audio, cfg):
    """The project stage of each fragment type (`audio`: fragment type ->
    waveforms) as the JAX package computes it on the same grouped batches,
    except that the average pool and the projection after the trunk run op
    by op, outside `jax.jit`.  Under `jax.jit`, XLA computes the pool's
    bin edges floor(i T / 28) and ceil((i + 1) T / 28) with a
    multiplication by the rounded reciprocal of 28, so an edge that falls
    on an integer (T = 68 here: 7 x 68 / 28 = 17) can move by one frame;
    op by op, as in the reference's AdaptiveAvgPool2d and in the port, it
    does not (ROADMAP C.7)."""
    import flax.linen as nn

    from peppa_tpu.config import Config as JaxConfig
    from peppa_tpu.data.audio import grouped_audioarray_loader
    from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
    from peppa_tpu.models.layers import make_audio_pool
    from peppa_tpu.ops.similarity import l2_normalize
    from torch_port_grsa_run import jax_audio_init

    jcfg = JaxConfig.from_dict(cfg.to_dict())
    jcfg.audio.pooling = "average"
    model = JaxPeppaPig(jcfg)
    variables = jax_audio_init(jcfg, jax.random.PRNGKey(2))
    logits = jax.jit(lambda v, x: model.apply(v, x, tap="logits",
                                              method=model.encode_audio))
    project = {"params": variables["params"]["audio_encoder"]["project"]}
    out = {}
    for fragment_type, waves in audio.items():
        embs = []
        for batch in grouped_audioarray_loader(waves, batch_size=32):
            feats = logits(variables, jnp.asarray(batch))
            pooled = make_audio_pool("average", 28).apply({}, feats)
            emb = nn.Dense(512).apply(project, pooled)
            embs.append(np.asarray(l2_normalize(emb.astype(jnp.float32),
                                                axis=1)))
        out[fragment_type] = np.concatenate(embs)
    return out


@pytest.mark.parametrize("t", [28, 34, 68, 103, 317])
def test_average_pool_bins_are_the_reference_adaptive_pool(t):
    """The port's audio `AveragePool` is the reference's
    AdaptiveAvgPool2d((28, 1)) over (B, T, 28), integer bin edges
    included."""
    from peppa_tpu_torch.models.layers import AveragePool

    x = torch.randn(3, t, 28, generator=torch.Generator().manual_seed(t))
    want = torch.nn.AdaptiveAvgPool2d((28, 1))(x)[..., 0]
    torch.testing.assert_close(AveragePool(28)(x), want, rtol=1e-6,
                               atol=1e-6)


def test_embedder_stages_match_jax(embedders, grsa_run):
    got, want = embedders
    for attr in ("speaker", "spelling", "duration"):
        assert getattr(got, attr) == getattr(want, attr)
    project = jax_unjitted_project(want.audio, grsa_run["cfg"])
    for fragment_type in ("dialog", "narration"):
        assert all(np.array_equal(a, b) for a, b in zip(
            got.audio[fragment_type], want.audio[fragment_type]))
        stages = got.embedding[fragment_type]
        assert list(stages) == list(want.embedding[fragment_type]) == [
            "untrained", "trained", "project", "wav2vec", "conv"]
        for stage, x in stages.items():
            w = want.embedding[fragment_type][stage]
            if stage == "project":
                w = project[fragment_type]
            assert x.shape == w.shape, stage
            np.testing.assert_allclose(x, w, rtol=TOL, atol=TOL,
                                       err_msg=stage)
        assert stages["wav2vec"].shape == (8, 768)
        assert stages["conv"].shape == (8, 512)


def _same_embeddings(got, want):
    """A copy of the port's Embedder holding the JAX package's embeddings."""
    out = copy.copy(got)
    out.embedding = {f: dict(s) for f, s in want.embedding.items()}
    return out


def test_word_type_and_vanilla_rsa_match_jax(embedders, tmp_path,
                                             monkeypatch):
    got, want = embedders
    got = _same_embeddings(got, want)
    monkeypatch.chdir(tmp_path)  # the text embedder reads ./data
    g = G.word_type(got, str(tmp_path / "port"))
    w = J.word_type(want, str(tmp_path / "jax"))
    assert list(g.columns) == list(w.columns)
    assert g[["fragment_type", "N"]].equals(w[["fragment_type", "N"]])
    np.testing.assert_allclose(g["pearson_r"], w["pearson_r"], atol=TOL)
    assert open(tmp_path / "port" / "word_type_rsa.csv").read().split(
        "\n")[0] == "fragment_type,pearson_r,N"
    g = G.vanilla_rsa(got)
    w = J.vanilla_rsa(want)
    assert g[["label", "feature"]].equals(w[["label", "feature"]])
    np.testing.assert_allclose(g["r"], w["r"], atol=TOL)
    X = np.random.default_rng(0).normal(size=(6, 6))
    assert np.array_equal(G.triu(X), J.triu(X))
    assert G.pearson_r(X[0], X[1]) == J.pearson_r(X[0], X[1])
    assert G.rer(0.8, 0.5) == J.rer(0.8, 0.5)
    for balanced in (True, False):
        assert all(np.array_equal(a, b) for a, b in zip(
            G.prepare_probe(got, "conv", "speaker", balanced, seed=3),
            J.prepare_probe(want, "conv", "speaker", balanced, seed=3)))
