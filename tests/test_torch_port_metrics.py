"""The port's retrieval and triplet metrics against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and fed to both packages.  Ranking
is by a stable argsort in both, so exact ties (duplicated rows) rank the
same way and the 0/1 per-row recalls are held for equality; the bootstrap
is held for equality on the JAX package's own index sets.  The port's own
draws (a torch generator) cannot match `jax.random.permutation`: their
mean is held within 3 bootstrap standard errors of the JAX package's.
Triplet rounds are drawn by the same `random.Random(seed)` code in both,
so accuracies and durations are equal; the continuous differences of
`comparative_score_triplets` agree within 1e-6 (float32 cosines).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.evaluation import triplet as jax_triplet
from peppa_tpu.ops import metrics as jax_metrics
from peppa_tpu.ops.similarity import cosine_similarity as jax_cosine_sim
from peppa_tpu_torch.evaluation import triplet
from peppa_tpu_torch.ops import metrics
from peppa_tpu_torch.ops.similarity import cosine_similarity


def _with_ties(rng, n=24, d=16):
    """Candidates and references with duplicated rows: exact ties."""
    c = rng.normal(size=(n, d)).astype(np.float32)
    r = rng.normal(size=(n, d)).astype(np.float32)
    c[5] = c[2]  # two candidates tie for every reference
    c[11] = c[2]
    r[7] = r[3]  # two references rank alike
    c[9] = 2.0 * c[4]  # the same direction: an exact tie after normalising
    return c, r


def _jax_subsets(total, size, n_samples, seed):
    """The index sets `resampled_recall` draws from PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_samples)
    return np.stack([np.asarray(jax.random.permutation(k, total)[:size])
                     for k in keys])


@pytest.mark.parametrize("n", [1, 3, 10])
def test_recall_at_n_matches_jax(n):
    c, r = _with_ties(np.random.default_rng(0))
    correct = np.eye(len(c), dtype=np.float32)
    correct[0, 5] = correct[3, 11] = 1  # rows with two targets
    want = np.asarray(jax_metrics.recall_at_n(
        jnp.asarray(c), jnp.asarray(r), jnp.asarray(correct), n=n))
    got = metrics.recall_at_n(torch.from_numpy(c), torch.from_numpy(r),
                              torch.from_numpy(correct), n=n).numpy()
    np.testing.assert_array_equal(got, want)


def test_recall_curve_matches_jax():
    c, r = _with_ties(np.random.default_rng(1))
    correct = np.eye(len(c), dtype=np.float32)
    want = np.asarray(jax_metrics.recall_at_1_to_n(
        jnp.asarray(c), jnp.asarray(r), jnp.asarray(correct), N=10))
    got = metrics.recall_at_1_to_n(torch.from_numpy(c), torch.from_numpy(r),
                                   torch.from_numpy(correct), N=10).numpy()
    assert got.shape == want.shape == (11, len(c))
    np.testing.assert_array_equal(got, want)


def test_triplet_accuracy_matches_jax_with_ties():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(32, 16)).astype(np.float32)
    p = rng.normal(size=(32, 16)).astype(np.float32)
    n = rng.normal(size=(32, 16)).astype(np.float32)
    n[:6] = p[:6]  # ties: sign(0) gives 0.5
    for discrete in (True, False):
        want = np.asarray(jax_metrics.triplet_accuracy(
            jnp.asarray(a), jnp.asarray(p), jnp.asarray(n),
            discrete=discrete))
        got = metrics.triplet_accuracy(
            torch.from_numpy(a), torch.from_numpy(p), torch.from_numpy(n),
            discrete=discrete).numpy()
        if discrete:
            np.testing.assert_array_equal(got, want)
            assert (got[:6] == 0.5).all()
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        cosine_similarity(torch.from_numpy(a), torch.from_numpy(p)).numpy(),
        np.asarray(jax_cosine_sim(jnp.asarray(a), jnp.asarray(p))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [1, 10])
def test_bootstrap_on_jax_subsets_equals_jax(n):
    rng = np.random.default_rng(3)
    c = rng.normal(size=(130, 32)).astype(np.float32)
    r = (c + 1.5 * rng.normal(size=(130, 32))).astype(np.float32)
    r[17] = r[40]  # a duplicated reference row
    want = np.asarray(jax_metrics.resampled_recall(
        jnp.asarray(c), jnp.asarray(r), jax.random.PRNGKey(7), size=100,
        n_samples=12, n=n))
    idx = _jax_subsets(130, 100, 12, seed=7)
    got = metrics.recall_from_indices(torch.from_numpy(c),
                                      torch.from_numpy(r),
                                      torch.from_numpy(idx), n=n).numpy()
    assert got.shape == want.shape == (12, 100)
    np.testing.assert_array_equal(got, want)


def test_bootstrap_curve_on_jax_subsets_equals_jax():
    rng = np.random.default_rng(4)
    c = rng.normal(size=(60, 16)).astype(np.float32)
    r = (c + rng.normal(size=(60, 16))).astype(np.float32)
    want = np.asarray(jax_metrics.resampled_recall_at_1_to_n(
        jnp.asarray(c), jnp.asarray(r), jax.random.PRNGKey(3), size=40,
        n_samples=6, N=10))
    idx = _jax_subsets(60, 40, 6, seed=3)
    got = metrics.recall_curve_from_indices(
        torch.from_numpy(c), torch.from_numpy(r), torch.from_numpy(idx),
        N=10).numpy()
    assert got.shape == want.shape == (6, 11, 40)
    np.testing.assert_array_equal(got, want)


def test_own_draws_agree_with_jax_within_the_bootstrap_spread():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(150, 32)).astype(np.float32)
    r = (c + 4.0 * rng.normal(size=(150, 32))).astype(np.float32)
    want = np.asarray(jax_metrics.resampled_recall(
        jnp.asarray(c), jnp.asarray(r), jax.random.PRNGKey(0), size=100,
        n_samples=200, n=10)).mean(axis=1)
    got = metrics.resampled_recall(torch.from_numpy(c), torch.from_numpy(r),
                                   seed=0, size=100, n_samples=200,
                                   n=10).numpy().mean(axis=1)
    se = np.sqrt(want.var() / len(want) + got.var() / len(got))
    assert 0.2 < want.mean() < 0.9  # neither saturated nor at chance
    assert abs(got.mean() - want.mean()) <= 3 * se, (got.mean(), want.mean())
    # a seed gives the same subsets; another seed others
    again = metrics.bootstrap_indices(150, 100, 4, seed=0)
    assert torch.equal(again, metrics.bootstrap_indices(150, 100, 4, seed=0))
    assert not torch.equal(again, metrics.bootstrap_indices(150, 100, 4, 1))


def test_resampled_recall_identity_and_random_baseline():
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(150, 32)).astype(np.float32))
    out = metrics.resampled_recall(emb, emb, seed=0, size=100, n_samples=20,
                                   n=1)
    assert out.shape == (20, 100)
    np.testing.assert_array_equal(out.numpy(), 1.0)
    c = torch.from_numpy(rng.normal(size=(120, 64)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(120, 64)).astype(np.float32))
    out = metrics.resampled_recall(c, r, seed=1, size=100, n_samples=50,
                                   n=10)
    assert 0.05 < out.mean().item() < 0.15
    curve = metrics.resampled_recall_at_1_to_n(c, r, seed=1, size=100,
                                               n_samples=50, N=10)
    assert curve.shape == (50, 11, 100)
    np.testing.assert_array_equal(curve[:, 10].numpy(), out.numpy())


def _embeddings(seed, n=40, d=16):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(n, d)).astype(np.float32)
    audio = (video + rng.normal(size=(n, d))).astype(np.float32)
    video[7] = video[3]  # a tie between a target and its distractor
    duration = rng.integers(1, 4, size=n).astype(np.float32)
    return video, audio, duration


@pytest.mark.parametrize("seed", [0, 5])
def test_score_triplets_equals_jax(seed):
    video, audio, duration = _embeddings(6)
    want = jax_triplet.score_triplets(video, audio, duration, n_samples=50,
                                      seed=seed)
    got = triplet.score_triplets(video, audio, duration, n_samples=50,
                                 seed=seed)
    assert got["accuracy"].shape == (50,)
    np.testing.assert_array_equal(got["accuracy"], want["accuracy"])
    np.testing.assert_array_equal(got["duration"], want["duration"])
    # tensors in, the same out
    again = triplet.score_triplets(torch.from_numpy(video),
                                   torch.from_numpy(audio), duration,
                                   n_samples=50, seed=seed)
    np.testing.assert_array_equal(again["accuracy"], want["accuracy"])


def test_comparative_score_triplets_matches_jax():
    sets = [_embeddings(s) for s in (7, 8)]
    duration = sets[0][2]
    want = jax_triplet.comparative_score_triplets(
        [s[0] for s in sets], [s[1] for s in sets], duration, n_samples=20,
        seed=3)
    got = triplet.comparative_score_triplets(
        [s[0] for s in sets], [s[1] for s in sets], duration, n_samples=20,
        seed=3)
    np.testing.assert_array_equal(got["duration"], want["duration"])
    assert len(got["success"]) == 2
    for g, w in zip(got["success"], want["success"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_score_triplets_without_pairs_raises_like_jax():
    video, audio, _ = _embeddings(9)
    video, audio = video[:3], audio[:3]
    duration = np.array([1.0, 2.0, 3.0], np.float32)  # no two alike
    with pytest.raises(ValueError, match="No duration-matched pairs"):
        jax_triplet.score_triplets(video, audio, duration, n_samples=2,
                                   seed=0)
    with pytest.raises(ValueError, match="No duration-matched pairs"):
        triplet.score_triplets(video, audio, duration, n_samples=2, seed=0)
