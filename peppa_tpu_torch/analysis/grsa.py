"""GRSA: representational similarity and probing analysis of the audio
embeddings.

The port's copy of peppa_tpu/analysis/grsa.py (reference pig/grsa.py):
word- and utterance-level audio embeddings from several model stages
correlated against text-side semantics, phoneme edit distance, speaker
and episode identity and duration; MLP probing and vanilla RSA.

The stages are the audio tower's tap points (`models/wav2vec2.py`):

  trained   = `encode_audio` of the run's best checkpoint
  untrained = the same architecture, seeded random init
  project   = seeded random init with `audio.pooling: average`
  wav2vec   = tap 'context' (the transformer's output), mean over time
  conv      = tap 'conv' (the feature extractor's output), mean over time

The model side (`Embedder.embed`, `pairwise`, `embed_utterances`) runs on
`device` (None: the card; raises without CUDA), where the attention kernel
launches once per transformer layer of every batch; the similarities,
regressions and probes are host work in numpy, with pandas, sklearn,
matplotlib and Levenshtein imported inside the functions.  The random
inits are the port's own `init_model(cfg, seed=1|2)`: torch's draws, which
cannot match the JAX package's `PRNGKey(1|2)` ones.  Time means include
the padding (`mask_padding=False`), and are taken in float32 on the host.

Text embedders, in the JAX package's order under "auto": a
SentenceTransformer when its snapshot is in the Hugging Face cache (looked
for before the import), GloVe vectors from data/in/glove/*.txt, PPMI-SVD
vectors trained on the realigned transcripts (`analysis/embeddings.py`),
and a character-n-gram hashing embedder, which needs nothing.

    python -m peppa_tpu_torch.analysis.grsa [--versions 0] \\
        [--log_dir lightning_logs] [--data_dir data] \\
        [--out_csv data/out/pairwise_similarities.csv] [--device cpu]

writes the pairwise-similarity CSV that `analysis.stats` reads.
"""

from __future__ import annotations

import copy
import glob as globlib
import json
import logging
import os
import random
from argparse import ArgumentParser
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from peppa_tpu_torch.data.audio import (audioarray_loader,
                                        grouped_audioarray_loader)
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.ops.similarity import cosine_matrix
from peppa_tpu_torch.preprocess.ipa import arpa2ipa
from peppa_tpu_torch.utils.device import resolve_device

VERSIONS = [0]


def checkpoint_path(version, log_dir: str = "lightning_logs") -> str:
    return os.path.join(log_dir, f"version_{version}")


# ------------------------------------------------------------ speaker utils

def as_yaml(episodes, data_dir: str = "data") -> None:
    """Episode JSONs -> YAMLs with blank speaker slots for annotation.

    Reference pig/grsa.py:28-32.
    """
    import yaml

    outdir = os.path.join(data_dir, "out", "speaker_id")
    os.makedirs(outdir, exist_ok=True)
    for episode in episodes:
        with open(os.path.join(data_dir, "in", "peppa", "episodes",
                               f"ep_{episode}.json")) as f:
            data = json.load(f)
        speakerize(data)
        with open(os.path.join(outdir, f"ep_{episode}.yaml"), "w") as f:
            yaml.dump(data, f)


def speakerize(data: Dict) -> None:
    """Blank speaker slots for manual annotation (reference pig/grsa.py:34-37)."""
    for part in data["narrator_splits"]:
        for sub in part["context"]["subtitles"]:
            sub["speaker"] = None


def speakerize_tokens(context: Dict) -> None:
    """Propagate subtitle speaker labels onto tokens they contain.

    Reference pig/grsa.py:48-59 (interval containment).
    """
    import pandas as pd

    passages = [(pd.Timedelta(x["begin"]), pd.Timedelta(x["end"]), x["speaker"])
                for x in context["subtitles"] if x.get("speaker") is not None]
    for token in context.get("tokenized", []):
        tb, te = pd.Timedelta(token["begin"]), pd.Timedelta(token["end"])
        for begin, end, speaker in passages:
            if begin <= tb and end >= te:
                token["speaker"] = speaker


# --------------------------------------------------------------- utterances

@dataclass
class Utt:
    """One aligned word or utterance (reference pig/grsa.py:86-98)."""
    spelling: str
    duration: float
    speaker: Optional[str]
    phonemes: Optional[str] = None
    episode: Optional[int] = None
    audio: Optional[np.ndarray] = None  # (S,) waveform
    embedding_1: Optional[np.ndarray] = None
    embedding_2: Optional[np.ndarray] = None
    embedding_t: Optional[np.ndarray] = None


def episode_id(path: str) -> int:
    return int(path.split("/")[-3].split("_")[1])


def meta_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".json"


def phonemes_of(phones: Sequence[Dict]) -> str:
    """IPA string of a gentle phone list (reference pig/grsa.py:79-85)."""
    ipa = [arpa2ipa(p["phone"].split("_")[0]) for p in phones]
    if None in ipa:
        raise ValueError(f"Unknown ARPA transcription "
                         f"{[p['phone'] for p in phones]}")
    return "".join(ipa)


class UttData:
    """Aligned words/utterances from realign wav+json pairs.

    Reference pig/grsa.py:101-161 (UttData.words / multiwords).  Audio is
    decoded at `audio_sample_rate`, 44.1 kHz unless a caller passes
    another: no caller does, whatever the run's config says.
    """

    def __init__(self, audio_paths: Sequence[str],
                 alignment_paths: Sequence[str], multiword: bool = False,
                 audio_sample_rate: int = 44100):
        self.items = list(zip(audio_paths, alignment_paths))
        self.multiword = multiword
        self.min_duration = 0.0
        self.audio_sample_rate = audio_sample_rate

    def valid_word(self, word: Dict) -> bool:
        return (word.get("case") == "success"
                and word["end"] - word["start"] >= self.min_duration)

    def valid_multiword(self, words: Sequence[Dict]) -> bool:
        return (bool(words)
                and all(w.get("case") == "success" for w in words)
                and words[-1]["end"] - words[0]["start"] >= self.min_duration)

    def _audio(self, path: str, start: float, end: float) -> np.ndarray:
        from peppa_tpu_torch.data import decode as D

        return D.decode_audio(path, start, end, self.audio_sample_rate)

    def words(self, read_audio: bool = True,
              embed: Optional[Callable] = None) -> Iterator[Utt]:
        for audio_path, alignment_path in self.items:
            with open(alignment_path) as f:
                meta = json.load(f)
            for word in meta.get("words", []):
                if not self.valid_word(word):
                    continue
                phon = None
                if word.get("phones"):
                    try:
                        phon = phonemes_of(word["phones"])
                    except ValueError:
                        phon = None
                yield Utt(
                    spelling=word["word"],
                    duration=word["end"] - word["start"],
                    speaker=meta.get("speaker"),
                    phonemes=phon,
                    episode=episode_id(audio_path),
                    audio=(self._audio(audio_path, word["start"], word["end"])
                           if read_audio else None),
                    embedding_t=(np.asarray(embed(word["word"]))
                                 if embed is not None else None))

    def multiwords(self, read_audio: bool = True,
                   embed: Optional[Callable] = None) -> Iterator[Utt]:
        for audio_path, alignment_path in self.items:
            with open(alignment_path) as f:
                meta = json.load(f)
            words = meta.get("words", [])
            if not self.valid_multiword(words):
                continue
            text = " ".join(w["word"] for w in words)
            yield Utt(
                spelling=text,
                duration=words[-1]["end"] - words[0]["start"],
                speaker=meta.get("speaker"),
                episode=episode_id(audio_path),
                audio=(self._audio(audio_path, words[0]["start"],
                                   words[-1]["end"]) if read_audio else None),
                embedding_t=(np.asarray(embed(text))
                             if embed is not None else None))

    def utterances(self, **kwargs) -> Iterator[Utt]:
        yield from (self.multiwords(**kwargs) if self.multiword
                    else self.words(**kwargs))


def realign_paths(fragment_type: str, data_dir: str = "data"
                  ) -> Tuple[List[str], List[str]]:
    """(audio_paths, alignment_paths) for a fragment's realign tree.

    Alignment JSONs are the source of truth (they always ship); the paired
    .wav paths are derived and only need to exist for read_audio=True.
    """
    annos = sorted(globlib.glob(os.path.join(
        data_dir, "out", "realign", fragment_type, "ep_*", "*", "*.json")))
    return [os.path.splitext(p)[0] + ".wav" for p in annos], annos


# ------------------------------------------------------------ text embedders

def normalized_distance(a: str, b: str) -> float:
    """Length-normalized Levenshtein distance (reference pig/grsa.py:163-165)."""
    from Levenshtein import distance

    return distance(a, b) / max(len(a), len(b))


def hashing_text_embedder(dim: int = 300, n: int = 3) -> Callable:
    """Deterministic char-n-gram hashing embedding (download-free fallback)."""

    def embed(text: str) -> np.ndarray:
        v = np.zeros((dim,), np.float32)
        s = f"#{text.lower()}#"
        for i in range(max(len(s) - n + 1, 1)):
            h = hash(s[i:i + n]) % dim
            v[h] += 1.0
        norm = np.linalg.norm(v)
        return v / norm if norm > 0 else v

    return embed


def glove_text_embedder(path: Optional[str] = None, dim: int = 300,
                        data_dir: str = "data") -> Optional[Callable]:
    """Word-vector embedder from a local GloVe .txt (summed over words).

    Files sort by name: a real glove.840B subset dropped into data/in/glove/
    wins over the trained zz_corpus_glove.*.txt (analysis/glove.py).  The
    vector dimension is taken from the file itself.
    """
    if path is None:
        cands = sorted(globlib.glob(
            os.path.join(data_dir, "in", "glove", "*.txt")))
        if not cands:
            return None
        path = cands[0]
    vectors: Dict[str, np.ndarray] = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            try:
                # glove.840B carries multiword tokens ('. . .', 'at name@…')
                # whose tails are not all floats: skip them
                vectors[parts[0]] = np.asarray(parts[1:], np.float32)
            except ValueError:
                continue
    if vectors:
        dim = len(next(iter(vectors.values())))

    def embed(text: str) -> np.ndarray:
        vs = [vectors.get(w.lower(), np.zeros(dim, np.float32))
              for w in text.split()]
        return np.sum(vs, axis=0)

    return embed


_ST_MODEL = "sentence-transformers/all-MiniLM-L6-v2"


def _st_model_cached(name: str = _ST_MODEL) -> bool:
    """True iff the HF snapshot for `name` already exists on disk.

    Checked before importing sentence_transformers: the import alone takes
    tens of seconds, and constructing the model without a local snapshot
    stalls on hub retries on a machine without network access, so absence
    is decided from the file system, not from an exception.
    """
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME")
        or os.path.expanduser("~/.cache/huggingface"), "hub")
    snap = os.path.join(hub, "models--" + name.replace("/", "--"), "snapshots")
    return os.path.isdir(snap) and bool(os.listdir(snap))


def sentence_transformer_embedder() -> Optional[Callable]:
    if not _st_model_cached():
        logging.warning("SentenceTransformer unavailable: no local snapshot "
                        "of %s", _ST_MODEL)
        return None
    # never touch the network, even for revision checks on a cached model —
    # but scope the offline switch to the construction: leaving
    # HF_HUB_OFFLINE=1 in os.environ would break unrelated hub downloads
    # later in the same process on machines that do have egress
    had = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        from sentence_transformers import SentenceTransformer

        try:
            encoder = SentenceTransformer(_ST_MODEL, local_files_only=True)
        except TypeError:  # sentence-transformers < 2.3 lacks the kwarg;
            encoder = SentenceTransformer(_ST_MODEL)  # offline env suffices
        return lambda text: np.asarray(encoder.encode([text])[0])
    except Exception as e:  # corrupt/partial snapshot
        logging.warning("SentenceTransformer unavailable: %s", e)
        return None
    finally:
        if had is None:
            os.environ.pop("HF_HUB_OFFLINE", None)
        else:
            os.environ["HF_HUB_OFFLINE"] = had


def corpus_text_embedder(data_dir: str = "data") -> Optional[Callable]:
    """Embedder over PPMI-SVD vectors trained on the realigned transcripts.

    Real distributional semantics for exactly the vocabulary GRSA probes
    (analysis/embeddings.py), replacing the semantics-free hashing fallback
    when no GloVe/SentenceTransformer files are present.
    """
    from peppa_tpu_torch.analysis.embeddings import corpus_word_vectors

    vectors = corpus_word_vectors(data_dir)
    if not vectors:
        return None
    dim = len(next(iter(vectors.values())))
    zero = np.zeros(dim, np.float32)

    def embed(text: str) -> np.ndarray:
        toks = [w for w in text.lower().replace(",", " ").replace(".", " ")
                .replace("!", " ").replace("?", " ").split() if w]
        vs = [vectors.get(w, zero) for w in toks]
        return np.sum(vs, axis=0) if vs else zero.copy()

    return embed


def make_text_embedder(kind: str = "auto", data_dir: str = "data") -> Callable:
    if kind in ("st", "auto"):
        st = sentence_transformer_embedder()
        if st is not None:
            return st
        if kind == "st":
            raise RuntimeError("sentence-transformers model unavailable")
    if kind in ("glove", "auto"):
        gl = glove_text_embedder(data_dir=data_dir)
        if gl is not None:
            return gl
        if kind == "glove":
            raise RuntimeError("no local GloVe vectors found")
    if kind == "glove_corpus":
        # train (once, cached) the GloVe objective on the realign corpus
        from peppa_tpu_torch.analysis.glove import ensure_corpus_glove

        path = ensure_corpus_glove(data_dir)
        return glove_text_embedder(path=path, data_dir=data_dir)
    if kind in ("corpus", "auto"):
        ce = corpus_text_embedder(data_dir=data_dir)
        if ce is not None:
            logging.info("using corpus-trained PPMI-SVD word vectors")
            return ce
        if kind == "corpus":
            raise RuntimeError("no realign corpus to train vectors on")
    logging.warning("falling back to hashing text embedder")
    return hashing_text_embedder()


# ----------------------------------------------------------- audio embedders

def _load(version, log_dir: str, device: torch.device):
    from peppa_tpu_torch.training.checkpoint import load_best_model

    model, config, _ = load_best_model(checkpoint_path(version, log_dir),
                                       device=device)
    return model, config


def _encode(model, batches, tap: str = "embedding",
            pool_time: bool = False) -> List[np.ndarray]:
    """Each (B, S) numpy batch through the audio tower on the model's
    device, to float32 numpy on the host; `pool_time` averages over time,
    padding included."""
    dev = next(model.parameters()).device
    outs = []
    for batch in batches:
        with torch.inference_mode():
            out = model.encode_audio(torch.from_numpy(batch).to(dev), tap=tap)
        out = out.float().cpu().numpy()
        if pool_time:
            out = out.mean(axis=1)
        outs.append(out)
    return outs


def _cosine_matrix(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return cosine_matrix(t, t).numpy()


class Embedder:
    """Embeds the aligned words at every model stage (reference
    pig/grsa.py:415-493)."""

    def __init__(self, version, log_dir: str = "lightning_logs",
                 data_dir: str = "data"):
        self.version = version
        self.log_dir = log_dir
        self.data_dir = data_dir
        self.data: Dict[str, UttData] = {}
        self.audio = dict(dialog=[], narration=[])
        self.duration = dict(dialog=[], narration=[])
        self.speaker = dict(dialog=[], narration=[])
        self.spelling = dict(dialog=[], narration=[])
        self.embedding: Dict[str, Dict[str, np.ndarray]] = dict(
            dialog={}, narration={})
        for fragment_type in ("dialog", "narration"):
            audio_paths, anno_paths = realign_paths(fragment_type, data_dir)
            self.data[fragment_type] = UttData(audio_paths, anno_paths,
                                               multiword=False)

    def load_audio(self) -> None:
        for fragment_type in self.audio:
            for utt in self.data[fragment_type].utterances(read_audio=True):
                self.audio[fragment_type].append(utt.audio)
                self.speaker[fragment_type].append(utt.speaker)
                self.spelling[fragment_type].append(utt.spelling)
                self.duration[fragment_type].append(utt.duration)

    def embed(self, grouped: bool = True, batch_size: int = 32,
              device: Optional[Union[str, torch.device]] = None) -> None:
        """Five stages per fragment type (reference pig/grsa.py:437-474),
        on `device` (None: the card)."""
        dev = resolve_device(device)
        model, config = _load(self.version, self.log_dir, dev)
        cfg_untrained = copy.deepcopy(config)
        cfg_untrained.audio.pretrained = False
        untrained = init_model(cfg_untrained, seed=1, device=dev)
        cfg_avg = copy.deepcopy(config)
        cfg_avg.audio.pooling = "average"
        model_avg = init_model(cfg_avg, seed=2, device=dev)

        loader = (grouped_audioarray_loader if grouped else audioarray_loader)
        for fragment_type in self.embedding:
            arrays = self.audio[fragment_type]
            mk = lambda: loader(arrays, batch_size=batch_size)
            emb = self.embedding[fragment_type]
            emb["untrained"] = np.concatenate(_encode(untrained, mk()))
            emb["trained"] = np.concatenate(_encode(model, mk()))
            emb["project"] = np.concatenate(_encode(model_avg, mk()))
            emb["wav2vec"] = np.concatenate(_encode(model, mk(), "context",
                                                    pool_time=True))
            emb["conv"] = np.concatenate(_encode(model, mk(), "conv",
                                                 pool_time=True))

    def feature_label(self, fragment_type: str, feature: str, label: str):
        X = self.embedding[fragment_type][feature]
        Y = getattr(self, label)[fragment_type]
        pairs = [(x, y) for x, y in zip(X, Y) if y is not None]
        X, Y = zip(*pairs)
        return np.array(list(X)), np.array(list(Y))


# ----------------------------------------------------------------- analyses

def pairwise(version, fragment_type: str = "dialog", multiword: bool = False,
             embedder: str = "auto", log_dir: str = "lightning_logs",
             data_dir: str = "data", batch_size: int = 32,
             device: Optional[Union[str, torch.device]] = None
             ) -> Iterator[Dict]:
    """All-pairs similarity records (reference pig/grsa.py:205-270): the
    trained model's (sim_2) and a seeded random init's (sim_1) cosine, the
    text embedder's (semsim), phoneme distance, durations and identities.
    The device is resolved at the call; the rest runs as the records are
    drawn."""
    dev = resolve_device(device)
    return _pairwise(version, fragment_type, multiword, embedder, log_dir,
                     data_dir, batch_size, dev)


def _pairwise(version, fragment_type, multiword, embedder, log_dir,
              data_dir, batch_size, dev) -> Iterator[Dict]:
    audio_paths, anno_paths = realign_paths(fragment_type, data_dir)
    data = UttData(audio_paths, anno_paths, multiword=multiword)

    model, config = _load(version, log_dir, dev)
    untrained = init_model(copy.deepcopy(config), seed=1, device=dev)

    waveforms = [u.audio for u in data.utterances(read_audio=True)]
    emb_1, emb_2 = [], []
    for batch in audioarray_loader(waveforms, batch_size=batch_size):
        emb_1 += _encode(untrained, [batch])
        emb_2 += _encode(model, [batch])
    emb_1 = np.concatenate(emb_1) if emb_1 else np.zeros((0, 512))
    emb_2 = np.concatenate(emb_2) if emb_2 else np.zeros((0, 512))
    sim_1 = _cosine_matrix(emb_1)
    sim_2 = _cosine_matrix(emb_2)

    embed = make_text_embedder(embedder, data_dir)
    utts = list(data.utterances(read_audio=False, embed=embed))
    for i, utt in enumerate(utts):
        utt.embedding_1 = emb_1[i]
        utt.embedding_2 = emb_2[i]
    cos = lambda a, b: float(np.dot(a, b) /
                             max(np.linalg.norm(a) * np.linalg.norm(b), 1e-6))
    for i, u1 in enumerate(utts):
        for j, u2 in enumerate(utts):
            if i < j:
                yield dict(
                    spelling1=u1.spelling, phonemes1=u1.phonemes,
                    duration1=u1.duration, speaker1=u1.speaker,
                    episode1=u1.episode,
                    spelling2=u2.spelling, phonemes2=u2.phonemes,
                    duration2=u2.duration, speaker2=u2.speaker,
                    episode2=u2.episode,
                    distance=(normalized_distance(u1.phonemes, u2.phonemes)
                              if u1.phonemes and u2.phonemes else None),
                    semsim=cos(u1.embedding_t, u2.embedding_t),
                    sametype=u1.spelling == u2.spelling,
                    samespeaker=(None if u1.speaker is None
                                 or u2.speaker is None
                                 else u1.speaker == u2.speaker),
                    sameepisode=u1.episode == u2.episode,
                    dialog=fragment_type == "dialog",
                    durationdiff=abs(u1.duration - u2.duration),
                    sim_1=float(sim_1[i, j]), sim_2=float(sim_2[i, j]))


def embed_utterances(version, fragment_type: str = "dialog",
                     grouped: bool = True, embedder: str = "auto",
                     projection: bool = False,
                     log_dir: str = "lightning_logs", data_dir: str = "data",
                     batch_size: int = 32,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> List[Utt]:
    """Multiword utterances with trained (embedding_2), seeded random
    average-pooled (embedding_1; `audio.project` = `projection`) and text
    (embedding_t) embeddings (reference pig/grsa.py:167-203)."""
    dev = resolve_device(device)
    audio_paths, anno_paths = realign_paths(fragment_type, data_dir)
    data = UttData(audio_paths, anno_paths, multiword=True)

    model, config = _load(version, log_dir, dev)
    cfg_1 = copy.deepcopy(config)
    cfg_1.audio.pooling = "average"
    cfg_1.audio.project = projection
    model_1 = init_model(cfg_1, seed=1, device=dev)

    waveforms = [u.audio for u in data.utterances(read_audio=True)]
    loader = grouped_audioarray_loader if grouped else audioarray_loader
    emb_1 = np.concatenate(_encode(model_1, loader(waveforms,
                                                   batch_size=batch_size)))
    emb_2 = np.concatenate(_encode(model, loader(waveforms,
                                                 batch_size=batch_size)))
    embed = make_text_embedder(embedder, data_dir)
    utts = list(data.utterances(read_audio=False, embed=embed))
    for i, utt in enumerate(utts):
        utt.embedding_1 = emb_1[i]
        utt.embedding_2 = emb_2[i]
    return utts


def unpairwise_data(utts: Sequence[Utt], seed: Optional[int] = None
                    ) -> Iterator[Dict]:
    """Random disjoint pair records (reference pig/grsa.py:292-321)."""
    utts = list(utts)
    random.Random(seed).shuffle(utts)
    cos = lambda a, b: float(np.dot(a, b) /
                             max(np.linalg.norm(a) * np.linalg.norm(b), 1e-6))
    for i in range(0, len(utts) - 1, 2):
        u1, u2 = utts[i], utts[i + 1]
        yield dict(
            spelling1=u1.spelling, duration1=u1.duration, speaker1=u1.speaker,
            episode1=u1.episode,
            spelling2=u2.spelling, duration2=u2.duration, speaker2=u2.speaker,
            episode2=u2.episode,
            sametype=u1.spelling == u2.spelling,
            samespeaker=(None if u1.speaker is None or u2.speaker is None
                         else u1.speaker == u2.speaker),
            sameepisode=u1.episode == u2.episode,
            durationdiff=abs(u1.duration - u2.duration),
            durationsum=u1.duration + u2.duration,
            distance=normalized_distance(u1.spelling, u2.spelling),
            semsim=cos(u1.embedding_t, u2.embedding_t),
            sim_1=cos(u1.embedding_1, u2.embedding_1),
            sim_2=cos(u1.embedding_2, u2.embedding_2))


def unpairwise(version, grouped: bool = True, embedder: str = "auto",
               n_samples: int = 100, log_dir: str = "lightning_logs",
               data_dir: str = "data", results_dir: str = "results",
               device: Optional[Union[str, torch.device]] = None) -> None:
    """Resampled unpairwise OLS and its boxplots (reference
    pig/grsa.py:274-290)."""
    import pandas as pd

    from peppa_tpu_torch.analysis.stats import unpairwise_ols

    dev = resolve_device(device)
    dialog = embed_utterances(version, "dialog", grouped=grouped,
                              embedder=embedder, projection=True,
                              log_dir=log_dir, data_dir=data_dir, device=dev)
    narration = embed_utterances(version, "narration", grouped=grouped,
                                 embedder=embedder, projection=True,
                                 log_dir=log_dir, data_dir=data_dir,
                                 device=dev)
    utts = [u for u in dialog + narration if u.speaker is not None]
    results = []
    for n in range(n_samples):
        df = pd.DataFrame.from_records(unpairwise_data(utts, seed=n))
        result = unpairwise_ols(df)
        result["sample"] = n
        results.append(result)
    table = pd.concat(results)
    os.makedirs(results_dir, exist_ok=True)
    table.to_csv(os.path.join(results_dir, "unpairwise_coef.csv"),
                 index=False, header=True)
    # boxplots of coefficient distributions per variable
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    variables = [v for v in table["Variable"].unique() if v != "Intercept"]
    for di, dep in enumerate(("sim_1", "sim_2")):
        sub = table[table["Dependent Var."] == dep]
        vals = [sub[sub["Variable"] == v]["Value"].to_numpy()
                for v in variables]
        pos = np.arange(len(variables)) + (di - 0.5) * 0.3
        bp = ax.boxplot(vals, positions=pos, vert=False, widths=0.25,
                        showfliers=False, patch_artist=True)
        for box in bp["boxes"]:
            box.set_facecolor(f"C{di}")
    ax.set_yticks(range(len(variables)))
    ax.set_yticklabels(variables)
    ax.axvline(0, color="gray", linestyle="--")
    fig.tight_layout()
    fig.savefig(os.path.join(results_dir, "unpairwise_boxplots.pdf"))
    plt.close(fig)


def word_type(embedder: Embedder, results_dir: str = "results",
              data_dir: str = "data"):
    """Type-level RSA (reference pig/grsa.py:324-348): per fragment type,
    each word type's mean trained token embedding; the type-by-type cosine
    matrix correlated with the text embedder's ("auto" over `data_dir`,
    which the JAX package leaves at its default)."""
    import pandas as pd

    embed = make_text_embedder("auto", data_dir)
    rows = []
    for fragment_type in ("dialog", "narration"):
        spellings = embedder.spelling[fragment_type]
        trained = embedder.embedding[fragment_type]["trained"]
        by_type: Dict[str, List[np.ndarray]] = {}
        for sp, emb in zip(spellings, trained):
            by_type.setdefault(sp.lower(), []).append(emb)
        types = sorted(by_type)
        emb_mat = np.stack([np.mean(by_type[t], axis=0) for t in types])
        txt_mat = np.stack([np.asarray(embed(t)) for t in types])
        sim_emb = triu(_cosine_matrix(emb_mat))
        sim_txt = triu(_cosine_matrix(txt_mat))
        rows.append(dict(fragment_type=fragment_type,
                         pearson_r=pearson_r(sim_emb, sim_txt),
                         N=len(types)))
    df = pd.DataFrame.from_records(rows)
    os.makedirs(results_dir, exist_ok=True)
    df.to_csv(os.path.join(results_dir, "word_type_rsa.csv"),
              index=False, header=True)
    return df


def rer(hi_acc: float, low_acc: float) -> float:
    return ((1 - low_acc) - (1 - hi_acc)) / (1 - low_acc)


def prepare_probe(embedder: Embedder, feature: str, label: str,
                  balanced: bool = True, seed: int = 0):
    """Features and labels of both fragment types; `balanced` draws as
    many narration items as there are dialog ones (reference
    pig/grsa.py:347-358)."""
    X_d, Y_d = embedder.feature_label("dialog", feature, label)
    X_n, Y_n = embedder.feature_label("narration", feature, label)
    if balanced:
        rng = random.Random(seed)
        ixs = rng.sample(range(len(Y_n)), min(len(Y_d), len(Y_n)))
        X = np.concatenate([X_d, X_n[ixs]])
        Y = np.concatenate([Y_d, Y_n[ixs]])
    else:
        X = np.concatenate([X_d, X_n])
        Y = np.concatenate([Y_d, Y_n])
    return X, Y


def probe(embedder: Embedder, labels: Sequence[str] = ("speaker",)):
    """MLP probing of each embedding stage (reference pig/grsa.py:360-396).
    The MLPs are unseeded, as in the JAX package."""
    from collections import Counter

    import pandas as pd
    from sklearn.model_selection import GridSearchCV
    from sklearn.neural_network import MLPClassifier, MLPRegressor
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler, scale as skscale

    records = []
    for label in labels:
        for feature in embedder.embedding["dialog"].keys():
            X, Y = prepare_probe(embedder, feature, label,
                                 balanced=label == "speaker")
            if label == "duration":
                model = GridSearchCV(
                    make_pipeline(StandardScaler(),
                                  MLPRegressor(max_iter=1000)),
                    param_grid={"mlpregressor__alpha":
                                [10.0 ** n for n in range(-4, 5)]},
                    n_jobs=-1)
                model.fit(X, skscale(Y))
                records.append(dict(model="ridge", label=label,
                                    feature=feature, maj=None,
                                    score=model.best_score_))
            else:
                count = Counter(Y)
                maj = max(count.values()) / sum(count.values())
                Y = np.array([z if count[z] > 4 else "other" for z in Y])
                model = GridSearchCV(
                    make_pipeline(StandardScaler(),
                                  MLPClassifier(max_iter=1000)),
                    param_grid={"mlpclassifier__alpha": [0.1, 1.0, 10],
                                "mlpclassifier__hidden_layer_sizes":
                                [(50,), (100,), (200,)]},
                    n_jobs=-1)
                model.fit(X, Y)
                records.append(dict(model="lr", label=label, feature=feature,
                                    maj=maj, score=rer(model.best_score_, maj)))
    return pd.DataFrame.from_records(records)


def triu(x: np.ndarray) -> np.ndarray:
    """Strict upper-triangular values (reference pig/util.py:38-41)."""
    return x[np.triu(np.ones_like(x), k=1) == 1]


def pearson_r(x: np.ndarray, y: np.ndarray, eps: float = 1e-8) -> float:
    x1 = x - x.mean()
    y1 = y - y.mean()
    return float((x1 * y1).sum() /
                 max(np.linalg.norm(x1) * np.linalg.norm(y1), eps))


def vanilla_rsa(embedder: Embedder, labels: Sequence[str] = ("speaker",)):
    """RSA of embedding similarity vs label identity (pig/grsa.py:398-409)."""
    import pandas as pd

    records = []
    for label in labels:
        for feature in embedder.embedding["dialog"].keys():
            X, Y = prepare_probe(embedder, feature, label)
            X_sim = _cosine_matrix(X)
            Y_sim = (Y[:, None] == Y[None, :]).astype(np.float32)
            records.append(dict(label=label, feature=feature,
                                r=pearson_r(triu(X_sim), triu(Y_sim))))
    return pd.DataFrame.from_records(records)


def main(versions=VERSIONS, log_dir: str = "lightning_logs",
         data_dir: str = "data",
         out_csv: str = "data/out/pairwise_similarities.csv",
         device: Optional[Union[str, torch.device]] = None) -> None:
    """`pairwise` of each version, fragment type and word/multiword unit
    into one CSV (reference pig/grsa.py:495-512)."""
    import pandas as pd

    dev = resolve_device(device)
    logging.getLogger().setLevel(logging.INFO)
    tables = []
    for version in versions:
        for fragment_type in ("dialog", "narration"):
            for multiword in (True, False):
                df = pd.DataFrame.from_records(
                    pairwise(version, fragment_type=fragment_type,
                             multiword=multiword, log_dir=log_dir,
                             data_dir=data_dir, device=dev))
                df["version"] = version
                df["fragment_type"] = fragment_type
                df["multiword"] = multiword
                tables.append(df)
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    pd.concat(tables).to_csv(out_csv, index=False, header=True, na_rep="NA")


def cli(argv: Optional[List[str]] = None) -> int:
    p = ArgumentParser(description="GRSA pairwise similarities")
    p.add_argument("--versions", type=int, nargs="+", default=VERSIONS)
    p.add_argument("--log_dir", default="lightning_logs")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--out_csv", default="data/out/pairwise_similarities.csv")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    main(args.versions, log_dir=args.log_dir, data_dir=args.data_dir,
         out_csv=args.out_csv, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
