"""Corpus-trained word vectors: PPMI + SVD over the realigned transcripts.

The port's copy of peppa_tpu/analysis/embeddings.py, with its arithmetic,
so that the vectors are bit-equal.  The reference's GRSA semantic side
uses GloVe-840B vectors and a SentenceTransformer (pig/grsa.py:192-197,
231); without those files, PPMI-weighted co-occurrence factorised by a
truncated SVD gives distributional vectors for exactly the vocabulary GRSA
probes, from the transcripts the analysis studies.  `grsa.make_text_embedder`
prefers a GloVe file, then these vectors, then hashing.
"""

from __future__ import annotations

import json
import logging
import os
import re
from collections import Counter
from typing import Dict, List, Optional

import numpy as np


def corpus_sentences(data_dir: str = "data") -> List[List[str]]:
    """Tokenized transcripts from the realign tree (dialog + narration)."""
    sentences = []
    root_dir = os.path.join(data_dir, "out", "realign")
    for root, _, files in os.walk(root_dir):
        for file in sorted(files):
            if not file.endswith(".json"):
                continue
            try:
                with open(os.path.join(root, file)) as f:
                    item = json.load(f)
                text = str(item.get("transcript", ""))
            except Exception:
                continue
            toks = [t for t in re.sub(r"[^a-z' ]", " ", text.lower()).split()
                    if t]
            if toks:
                sentences.append(toks)
    return sentences


def train_ppmi_svd(sentences: List[List[str]], dim: int = 100,
                   window: int = 5, min_count: int = 2,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """PPMI co-occurrence + truncated SVD word vectors (unit-normalized)."""
    counts = Counter(w for s in sentences for w in s)
    vocab = sorted(w for w, c in counts.items() if c >= min_count)
    if not vocab:
        return {}
    index = {w: i for i, w in enumerate(vocab)}
    n = len(vocab)
    co = np.zeros((n, n), np.float64)
    for s in sentences:
        ids = [index.get(w, -1) for w in s]
        for i, wi in enumerate(ids):
            if wi < 0:
                continue
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                wj = ids[j]
                if j != i and wj >= 0:
                    co[wi, wj] += 1.0
    total = co.sum()
    if total == 0:
        return {}
    row = co.sum(axis=1, keepdims=True)
    col = co.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log((co * total) / (row * col))
    ppmi = np.where(np.isfinite(pmi) & (pmi > 0), pmi, 0.0)
    dim = min(dim, n)
    # deterministic truncated SVD; vectors = U * sqrt(S) (standard weighting)
    u, s, _ = np.linalg.svd(ppmi, full_matrices=False)
    vecs = (u[:, :dim] * np.sqrt(s[:dim])).astype(np.float32)
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = vecs / np.maximum(norms, 1e-8)
    return {w: vecs[i] for w, i in index.items()}


def save_vectors(path: str, vectors: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    words = sorted(vectors)
    np.savez_compressed(path, words=np.asarray(words),
                        vectors=np.stack([vectors[w] for w in words]))


def load_vectors(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        words = [str(w) for w in z["words"]]
        vecs = z["vectors"].astype(np.float32)
    return {w: vecs[i] for i, w in enumerate(words)}


def corpus_word_vectors(data_dir: str = "data", dim: int = 100,
                        cache: bool = True) -> Optional[Dict[str, np.ndarray]]:
    """Train-or-load corpus vectors; cached at data/out/word_vectors.npz."""
    cache_path = os.path.join(data_dir, "out", "word_vectors.npz")
    if cache and os.path.exists(cache_path):
        try:
            return load_vectors(cache_path)
        except Exception:
            pass
    sentences = corpus_sentences(data_dir)
    if len(sentences) < 50:  # not enough corpus to mean anything
        return None
    vectors = train_ppmi_svd(sentences, dim=dim)
    if not vectors:
        return None
    logging.info("Trained %d-d PPMI-SVD vectors for %d words from %d "
                 "transcripts", dim, len(vectors), len(sentences))
    if cache:
        try:
            save_vectors(cache_path, vectors)
        except Exception:
            pass
    return vectors
