"""GloVe trained on the realigned transcripts (Pennington et al., 2014).

The port's copy of peppa_tpu/analysis/glove.py, with its arithmetic and
its `default_rng(seed)` draws, so that the vectors are bit-equal: the
GloVe objective (weighted least squares on log co-occurrence, AdaGrad,
W + W~) trained in numpy on the corpus the analysis studies, written in
GloVe's text format where `grsa.glove_text_embedder` looks
(data/in/glove/*.txt); a real glove.840B subset dropped there sorts first
and takes precedence.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np


def cooccurrence(sentences: List[List[str]], window: int = 10,
                 min_count: int = 2
                 ) -> Tuple[List[str], Dict[Tuple[int, int], float]]:
    """Symmetric, distance-weighted co-occurrence counts (GloVe §4.2:
    context words at distance d contribute 1/d)."""
    counts = Counter(w for s in sentences for w in s)
    vocab = sorted(w for w, c in counts.items() if c >= min_count)
    index = {w: i for i, w in enumerate(vocab)}
    co: Dict[Tuple[int, int], float] = {}
    for s in sentences:
        ids = [index[w] for w in s if w in index]
        for pos, wi in enumerate(ids):
            for off in range(1, window + 1):
                if pos + off >= len(ids):
                    break
                wj = ids[pos + off]
                w = 1.0 / off
                co[(wi, wj)] = co.get((wi, wj), 0.0) + w
                co[(wj, wi)] = co.get((wj, wi), 0.0) + w
    return vocab, co


def train_glove(sentences: List[List[str]], dim: int = 100,
                window: int = 10, min_count: int = 2, epochs: int = 30,
                x_max: float = 100.0, alpha: float = 0.75,
                lr: float = 0.05, seed: int = 0) -> Dict[str, np.ndarray]:
    """AdaGrad on the GloVe objective:
    sum_ij f(X_ij) (w_i . w~_j + b_i + b~_j - log X_ij)^2,
    f(x) = min(1, (x/x_max)^alpha).  Returns w_i + w~_i per word
    (the paper's composition), unit-normalized.
    """
    vocab, co = cooccurrence(sentences, window, min_count)
    if not vocab:
        return {}
    n = len(vocab)
    pairs = np.array(list(co.keys()), np.int64)
    xs = np.array(list(co.values()), np.float64)
    logx = np.log(xs)
    fx = np.minimum(1.0, (xs / x_max) ** alpha)

    rng = np.random.default_rng(seed)
    scale = 0.5 / dim
    W = rng.uniform(-scale, scale, (n, dim))
    Wc = rng.uniform(-scale, scale, (n, dim))
    b = np.zeros(n)
    bc = np.zeros(n)
    gW = np.ones((n, dim))
    gWc = np.ones((n, dim))
    gb = np.ones(n)
    gbc = np.ones(n)

    nnz = len(xs)
    for epoch in range(epochs):
        order = rng.permutation(nnz)
        total = 0.0
        # chunked vectorized AdaGrad; duplicate indices within a chunk are
        # resolved by np.add.at (exact sparse accumulation)
        for lo in range(0, nnz, 16384):
            idx = order[lo:lo + 16384]
            i, j = pairs[idx, 0], pairs[idx, 1]
            wi, wj = W[i], Wc[j]
            diff = (wi * wj).sum(axis=1) + b[i] + bc[j] - logx[idx]
            fdiff = fx[idx] * diff
            total += float((fdiff * diff).sum())
            grad_wi = fdiff[:, None] * wj
            grad_wj = fdiff[:, None] * wi
            np.add.at(W, i, -lr * grad_wi / np.sqrt(gW[i]))
            np.add.at(Wc, j, -lr * grad_wj / np.sqrt(gWc[j]))
            np.add.at(b, i, -lr * fdiff / np.sqrt(gb[i]))
            np.add.at(bc, j, -lr * fdiff / np.sqrt(gbc[j]))
            np.add.at(gW, i, grad_wi ** 2)
            np.add.at(gWc, j, grad_wj ** 2)
            np.add.at(gb, i, fdiff ** 2)
            np.add.at(gbc, j, fdiff ** 2)
        if epoch % 10 == 0 or epoch == epochs - 1:
            logging.info("glove epoch %d: loss %.4f", epoch, total / nnz)

    vecs = W + Wc
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = vecs / np.maximum(norms, 1e-8)
    return {w: vecs[i].astype(np.float32) for i, w in enumerate(vocab)}


def save_glove_txt(path: str, vectors: Dict[str, np.ndarray]) -> None:
    """Standard GloVe text format: `word v1 v2 ... vd` per line."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for w, v in vectors.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    os.replace(tmp, path)


def corpus_glove_path(data_dir: str = "data", dim: int = 100) -> str:
    # 'zz_' prefix: a real glove.840B subset dropped alongside sorts first
    # in glove_text_embedder's glob and takes precedence
    return os.path.join(data_dir, "in", "glove", f"zz_corpus_glove.{dim}d.txt")


def ensure_corpus_glove(data_dir: str = "data", dim: int = 100,
                        transcripts_dir: Optional[str] = None, **kw) -> str:
    """Train (once) and cache corpus GloVe vectors in data/in/glove/.

    `transcripts_dir` overrides where the realign transcripts are read from
    (default: data_dir) — the vectors are still cached under data_dir, which
    may be writable when the transcripts tree (e.g. the read-only reference
    checkout) is not.
    """
    from peppa_tpu_torch.analysis.embeddings import corpus_sentences

    src = transcripts_dir or data_dir
    path = corpus_glove_path(data_dir, dim)
    if os.path.exists(path):
        return path
    sentences = corpus_sentences(src)
    if not sentences:
        raise FileNotFoundError(
            f"no realigned transcripts under {src}/out/realign")
    vectors = train_glove(sentences, dim=dim, **kw)
    save_glove_txt(path, vectors)
    return path
