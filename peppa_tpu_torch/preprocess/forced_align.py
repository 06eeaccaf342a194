"""Forced alignment of subtitle text to audio.

Mirrors peppa_tpu/preprocess/forced_align.py (reference
pig/forced_align.py, which runs gentle): every subtitle line of an
episode is cut with 0.5 s margins, aligned word by word, and written as a
16 kHz WAV and a gentle-style JSON (`words[].{word, alignedWord, case,
start, end, phones[]}` plus the speaker and clip metadata) under
`data/out/realign/{fragment}/ep_{N}/{part}/{sub}.{wav,json}`, which the
eval-set generation and the GRSA analysis read.

The alignment is CTC Viterbi forced alignment over character log-probs:

- `make_ctc_logits_fn` runs the port's wav2vec2 (`models/wav2vec2.py`,
  float32, the 28-token char head `aux`) on the device: each wav is padded
  with zeros to a duration bucket (2, 4, 8, 16 s), attention is masked past
  its true length (`mask_padding=True`, so the attention kernel gets key
  lengths), and the log-softmax is sliced to the true frame count;
- `ctc_forced_align` is the DP over (frames, tokens) in C++
  (`native/src/ctc_align.cpp`, built by `native/build.py` at first use and
  called through ctypes, which releases the GIL); `_ctc_align_python` is
  its plain version, bit for bit the same.  A failed build raises: nothing
  falls back to the Python DP.

When the `gentle` package is importable, `align` uses it instead, as the
JAX package does.  `realign` runs the utterances of an episode in a thread
pool; the workers share the device's default stream.  pandas and PyYAML
are imported inside the functions that use them.
"""

from __future__ import annotations

import ctypes
import functools
import json
import logging
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# the torchaudio/fairseq 28-token char vocabulary for wav2vec2 CTC heads
CTC_CHARS = ["<s>", "<pad>", "</s>", "<unk>", "|", "E", "T", "A", "O", "N",
             "I", "H", "S", "R", "D", "L", "U", "M", "W", "C", "F", "G", "Y",
             "P", "B", "V", "K", "'", ]
BLANK = 1  # <pad> is the CTC blank in the fairseq convention
WORD_SEP = 4  # '|'
MARGIN_S = 0.5  # audio kept before and after each subtitle line
ALIGN_RATE = 16000  # the cut wavs' and the acoustic model's sample rate


def clean(text: str) -> str:
    """Strip bracketed annotations (reference pig/forced_align.py:69-72)."""
    return re.sub(r"\[[^()]*\]", "", text)


def _words(text: str) -> List[str]:
    return [w for w in re.split(r"\s+", clean(text).upper().strip()) if w]


def text_to_tokens(text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
    """Uppercase text -> CTC token ids + per-word (start, end) token spans."""
    vocab = {c: i for i, c in enumerate(CTC_CHARS)}
    tokens: List[int] = []
    word_spans: List[Tuple[int, int]] = []
    words = _words(text)
    for wi, word in enumerate(words):
        start = len(tokens)
        for ch in word:
            tokens.append(vocab.get(ch, 3))  # unknown chars -> <unk>
        word_spans.append((start, len(tokens)))
        if wi != len(words) - 1:
            tokens.append(WORD_SEP)
    return tokens, word_spans


@functools.lru_cache(maxsize=1)
def _native_align_lib() -> ctypes.CDLL:
    """The C++ Viterbi DP, built at first use (raises if it cannot be)."""
    from peppa_tpu_torch.native.build import build

    lib = ctypes.CDLL(build("ctc_align"))
    lib.ppk_ctc_align.restype = ctypes.c_int
    lib.ppk_ctc_align.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
    return lib


def _ctc_align_native(log_probs: np.ndarray, tokens: Sequence[int],
                      blank: int = BLANK) -> Tuple[np.ndarray, float]:
    lib = _native_align_lib()
    lp = np.ascontiguousarray(log_probs, np.float64)
    tok = np.ascontiguousarray(tokens, np.int32)
    T, V = lp.shape
    labels = np.empty((T,), np.int32)
    score = ctypes.c_double()
    rc = lib.ppk_ctc_align(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), T, V,
        tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tok),
        blank, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(score))
    if rc == 2:
        raise ValueError(f"token id out of range for vocab {V}")
    if rc != 0:
        raise ValueError(f"cannot align {len(tok)} tokens into {T} frames")
    return labels, float(score.value)


def ctc_forced_align(log_probs: np.ndarray, tokens: Sequence[int],
                     blank: int = BLANK) -> Tuple[np.ndarray, float]:
    """Viterbi forced alignment through the standard CTC graph.

    log_probs: (T, V) log softmax frames; tokens: target ids (no blanks).
    Returns (frame_labels, score): frame_labels[t] = index into `tokens` of
    the token emitted at frame t, or -1 for blank; score = best path
    log-likelihood.  States s = 0..2N, even = blank, odd = token (s-1)//2;
    skip transitions between different consecutive tokens.  Runs the C++
    DP; `_ctc_align_python` is its plain version.
    """
    T, _ = log_probs.shape
    N = len(tokens)
    if N == 0 or T < N:
        raise ValueError(f"cannot align {N} tokens into {T} frames")
    return _ctc_align_native(log_probs, tokens, blank)


def _ctc_align_python(log_probs: np.ndarray, tokens: Sequence[int],
                      blank: int = BLANK) -> Tuple[np.ndarray, float]:
    """The DP in Python: the native DP's plain version, the same IEEE f64
    compare/add sequence."""
    T, V = log_probs.shape
    N = len(tokens)
    S = 2 * N + 1
    NEG = -1e30

    def emit(s: int) -> int:
        return blank if s % 2 == 0 else tokens[(s - 1) // 2]

    alpha = np.full((T, S), NEG, np.float64)
    back = np.zeros((T, S), np.int32)
    alpha[0, 0] = log_probs[0, blank]
    alpha[0, 1] = log_probs[0, tokens[0]]
    for t in range(1, T):
        lp = log_probs[t]
        prev = alpha[t - 1]
        for s in range(S):
            best, arg = prev[s], s
            if s >= 1 and prev[s - 1] > best:
                best, arg = prev[s - 1], s - 1
            if (s >= 2 and s % 2 == 1
                    and tokens[(s - 1) // 2] != tokens[(s - 3) // 2]
                    and prev[s - 2] > best):
                best, arg = prev[s - 2], s - 2
            alpha[t, s] = best + lp[emit(s)]
            back[t, s] = arg
    end = S - 1 if alpha[T - 1, S - 1] >= alpha[T - 1, S - 2] else S - 2
    score = float(alpha[T - 1, end])
    labels = np.full((T,), -1, np.int32)
    s = end
    for t in range(T - 1, -1, -1):
        labels[t] = -1 if s % 2 == 0 else (s - 1) // 2
        s = back[t, s]
    return labels, score


def word_timings(labels: np.ndarray, tokens: Sequence[int],
                 word_spans: Sequence[Tuple[int, int]],
                 frame_seconds: float,
                 words: Sequence[str]) -> List[Dict]:
    """Frame labels -> gentle-style `words` entries with start/end seconds."""
    first = np.full((len(tokens),), -1, np.int64)
    last = np.full((len(tokens),), -1, np.int64)
    for t, lab in enumerate(labels):
        if lab >= 0:
            if first[lab] < 0:
                first[lab] = t
            last[lab] = t
    out = []
    for (t0, t1), word in zip(word_spans, words):
        tok_firsts = first[t0:t1]
        tok_lasts = last[t0:t1]
        ok = (tok_firsts >= 0).all()
        entry = {"word": word, "alignedWord": word.lower(),
                 "case": "success" if ok else "not-found-in-audio"}
        if ok:
            entry["start"] = float(tok_firsts.min() * frame_seconds)
            entry["end"] = float((tok_lasts.max() + 1) * frame_seconds)
            entry["phones"] = [
                {"phone": CTC_CHARS[tokens[ti]].lower(),
                 "duration": float((last[ti] - first[ti] + 1) * frame_seconds)}
                for ti in range(t0, t1)]
        out.append(entry)
    return out


def align_ctc(log_probs: np.ndarray, transcript: str,
              frame_seconds: float) -> Dict:
    """Align a transcript against CTC char log-probs -> gentle-style dict."""
    tokens, word_spans = text_to_tokens(transcript)
    words = _words(transcript)
    if not tokens:
        return {"transcript": transcript, "words": []}
    try:
        labels, score = ctc_forced_align(log_probs, tokens)
    except ValueError as e:
        logging.warning("alignment failed: %s", e)
        return {"transcript": transcript,
                "words": [{"word": w, "case": "not-found-in-audio"}
                          for w in words]}
    entries = word_timings(labels, tokens, word_spans, frame_seconds, words)
    return {"transcript": transcript, "words": entries,
            "log_likelihood": score}


def _ctc_variables(model, checkpoint_path: str) -> Dict:
    """The JAX-layout variables of `model` (a seeded init) with a fairseq
    or torchaudio wav2vec2 checkpoint's trunk in place."""
    import torch

    from peppa_tpu_torch.models import convert as C
    from peppa_tpu_torch.models.dual_encoder import _init_parameters

    state = C.load_torch_checkpoint(checkpoint_path)
    for wrapper in ("model", "state_dict"):  # fairseq / Lightning blobs
        if isinstance(state, dict) and wrapper in state:
            state = state[wrapper]
            break
    if any(k.startswith("encoder.transformer.") for k in state):
        trunk = C.convert_wav2vec2_torchaudio(state)
    else:
        trunk = C.convert_wav2vec2_fairseq(state)
    if "aux" not in trunk:
        logging.warning(
            "%s has no 28-d aux head (a pretraining-only checkpoint?) — "
            "the char head stays randomly initialized and alignments "
            "will be poor; use a CTC fine-tuned ASR checkpoint",
            checkpoint_path)
    _init_parameters(model, torch.Generator().manual_seed(0))
    params = dict(C.export_jax_variables(model)["params"])
    unknown = set(trunk) - set(params)
    if unknown:
        raise ValueError(f"converted tree has unknown modules {unknown}")
    params.update(trunk)
    return {"params": params}


def make_ctc_logits_fn(checkpoint_path: Optional[str] = None,
                       variables: Optional[Dict] = None,
                       bucket_seconds: Sequence[float] = (2.0, 4.0, 8.0, 16.0),
                       sample_rate: int = ALIGN_RATE,
                       cfg=None, device=None) -> Callable:
    """An audio path -> (frames, 28) float32 log-probs function, on the
    port's wav2vec2 in float32 (`cfg`: its `Wav2Vec2Config`, the base
    model's by default) on `device` (None: the card; raises without CUDA).

    The weights: `variables`, the JAX package's `{"params": ...}` tree of
    numpy arrays (`models/convert.py::export_jax_variables` gives one), or a
    fine-tuned wav2vec2 ASR checkpoint (fairseq or torchaudio names, told
    apart by key; the rest of the model a seeded init).  A checkpoint
    without the 28-d `aux` head warns: alignments from a random char head
    are poor.

    Each wav (decoded mono at `sample_rate`, at most the last bucket long)
    is zero-padded to the first bucket of `bucket_seconds` that holds it,
    the forward masks attention past its true length, and the log-softmax
    is sliced to `conv_output_length` of that length (frames of 320
    samples).  Calls may come from several threads at once; they share the
    device's default stream.
    """
    import torch

    from peppa_tpu_torch.data import decode as D
    from peppa_tpu_torch.models.convert import load_jax_variables
    from peppa_tpu_torch.models.wav2vec2 import (Wav2Vec2, Wav2Vec2Config,
                                                 conv_output_length)
    from peppa_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if variables is None and checkpoint_path is None:
        raise ValueError("pass checkpoint_path or variables")
    model = Wav2Vec2(cfg if cfg is not None else Wav2Vec2Config())
    if variables is None:
        variables = _ctc_variables(model, checkpoint_path)
    load_jax_variables(model, variables)
    model = model.eval().to(dev)
    sizes = [int(round(b * sample_rate)) for b in bucket_seconds]

    def fn(path: str) -> np.ndarray:
        samples = D.decode_audio(path, 0.0, bucket_seconds[-1], sample_rate)
        n = len(samples)
        size = next((s for s in sizes if n <= s), sizes[-1])
        wave = np.zeros((size,), np.float32)
        wave[:min(n, size)] = samples[:size]
        length = min(n, size)
        frames = int(conv_output_length(length))
        with torch.inference_mode():
            logits, _ = model(
                torch.from_numpy(wave).to(dev)[None],
                sample_lengths=torch.tensor([length], device=dev),
                deterministic=True, tap="logits", mask_padding=True)
            log_probs = torch.log_softmax(logits[0, :frames].float(), dim=-1)
            return log_probs.cpu().numpy()

    return fn


def have_gentle() -> bool:
    try:
        import gentle  # noqa: F401

        return True
    except Exception:
        return False


def align(audiopath: str, transcript: str,
          ctc_logits_fn: Optional[Callable] = None,
          frame_seconds: float = 320.0 / ALIGN_RATE) -> Dict:
    """Align one audio file: gentle when it is installed, else CTC over
    `ctc_logits_fn(audiopath)`'s (T, 28) log-probs (reference
    pig/forced_align.py:17-24)."""
    if have_gentle():
        import gentle

        resources = gentle.Resources()
        with gentle.resampled(audiopath) as wavfile:
            aligner = gentle.ForcedAligner(resources, transcript,
                                           disfluency=False,
                                           conservative=False)
            return json.loads(aligner.transcribe(wavfile).to_json())
    if ctc_logits_fn is None:
        raise RuntimeError("no alignment backend: install gentle or pass "
                           "ctc_logits_fn (a wav2vec2-CTC forward)")
    return align_ctc(np.asarray(ctc_logits_fn(audiopath)), transcript,
                     frame_seconds)


def _annotation(data_dir: str, fragment_type: str, epid: int
                ) -> Tuple[Optional[dict], str]:
    """(an episode's annotation or None, its path): for dialog the speaker
    file `data/out/speaker_id/ep_{N}.yaml` when there is one."""
    ann_path = os.path.join(data_dir, "in", "peppa", "episodes",
                            f"ep_{epid}.json")
    if fragment_type == "dialog":
        speaker_path = os.path.join(data_dir, "out", "speaker_id",
                                    f"ep_{epid}.yaml")
        if os.path.exists(speaker_path):
            import yaml

            with open(speaker_path) as f:
                return yaml.safe_load(f), speaker_path
    if not os.path.exists(ann_path):
        return None, ann_path
    with open(ann_path) as f:
        return json.load(f), ann_path


def _align_utterance(data_dir: str, fragment_type: str,
                     ctc_logits_fn: Optional[Callable], i: int, j: int,
                     sub: Dict, episode_file: str, ann_path: str,
                     title: str, epid: int) -> None:
    """Cut, align and write one subtitle line (`{j}.wav`, `{j}.json`)."""
    from peppa_tpu_torch.data import decode as D
    from peppa_tpu_torch.data.segment import total_seconds

    transcript = clean(sub["text"])
    if not transcript:
        return
    start = max(total_seconds(sub["begin"]) - MARGIN_S, 0.0)
    end = total_seconds(sub["end"]) + MARGIN_S
    outdir = os.path.join(data_dir, "out", "realign", fragment_type,
                          f"ep_{epid}", str(i))
    os.makedirs(outdir, exist_ok=True)
    wav = os.path.join(outdir, f"{j}.wav")
    _write_wav(wav, D.decode_audio(episode_file, start, end, ALIGN_RATE),
               ALIGN_RATE)
    result = align(wav, transcript, ctc_logits_fn=ctc_logits_fn)
    result["speaker"] = (sub.get("speaker") if fragment_type == "dialog"
                         else "Narrator")
    result["episode_filepath"] = episode_file
    result["episode_metadata_path"] = ann_path
    result["episode_title"] = title
    result["clipStart"] = start
    result["clipEnd"] = end
    result["partIndex"] = i
    result["clipIndex"] = j
    with open(os.path.join(outdir, f"{j}.json"), "w") as f:
        json.dump(result, f, indent=2)


def realign(fragment_type: str = "dialog", data_dir: str = "data",
            ctc_logits_fn: Optional[Callable] = None,
            splits: Sequence[str] = ("val",),
            nthreads: Optional[int] = None) -> None:
    """Re-align every subtitle line of the split's episodes (reference
    pig/forced_align.py:30-67): cut each line's audio with 0.5 s margins
    to a 16 kHz wav, align it, and write the wav and its JSON under
    `data/out/realign/{fragment}/ep_{N}/{part}/`.

    The lines of an episode run in a pool of `nthreads` threads (default:
    the CPU count); `list(pool.map(...))` re-raises the first worker's
    exception, as the serial path would.  Each line writes its own files,
    so the order does not matter.
    """
    from peppa_tpu_torch.data.dataset import SPLIT_SPEC
    from peppa_tpu_torch.preprocess.extract import episode_titles

    key = dict(narration="narration", dialog="context")[fragment_type]
    titles = episode_titles(data_dir)
    n = nthreads if nthreads is not None else (os.cpu_count() or 1)
    for split in splits:
        episodes = SPLIT_SPEC[fragment_type][split]
        if episodes is None:
            continue
        for epid in episodes:
            annotation, ann_path = _annotation(data_dir, fragment_type, epid)
            if annotation is None:
                continue
            episode_file = titles.get(annotation["title"])
            if episode_file is None or not os.path.exists(episode_file):
                logging.warning("missing episode media for %s",
                                annotation["title"])
                continue
            jobs = [(data_dir, fragment_type, ctc_logits_fn, i, j, sub,
                     episode_file, ann_path, annotation["title"], epid)
                    for i, part in enumerate(annotation["narrator_splits"])
                    for j, sub in enumerate(part[key].get("subtitles", []))]
            if n <= 1 or len(jobs) <= 1:
                for job in jobs:
                    _align_utterance(*job)
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=n) as pool:
                    list(pool.map(lambda job: _align_utterance(*job), jobs))


def _write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
