"""The evaluation battery: retrieval and triplet scores of trained runs.

Mirrors the scoring half of peppa_tpu/evaluation/evaluation.py:

- `full_score`: for each fragment type (dialog and narration on val,
  narration on test) and with the video scrambled and not, the
  duration-matched triplet accuracy over the subtitle lines
  (`TripletScorer`, 500 rounds) and bootstrap recall@0..10 over 500
  subsets of 100 pairs (`resampled_recall_at_1_to_n`) of fixed 2.3 s
  windows and of windows jittered by N(0, 0.5) s;
- `full_run` / `test_run`: `load_best_model` of each run version (the
  port's, the JAX package's or the reference's run directories), then
  `full_score`, saved as `results/full_scores_v{N}.pt` /
  `results/full_test_scores.pt`.

Every encode runs `make_predict`'s forward on the device (on the card the
attention forward kernel in the audio tower; no loss is computed).  Result
files are `torch.save` of lists of dicts whose arrays are numpy, with the
JAX package's keys, shapes and dtypes, so its analysis layer and the
reference's read them.  The bootstrap's subsets are drawn from a torch
generator seeded `EVAL_SEED` (they cannot match `jax.random`'s), the
triplet rounds from Python's `random.Random(EVAL_SEED)` (the JAX package's
own draws).  Scrambled windows are shuffled by an unseeded generator in
both packages.

From the result files to the paper's tables (host work; pandas imported
inside the functions): `merge_scores` (full_scores_v*.pt ->
full_scores.pt), `score_means`, `format_tables` (scores.csv and
scores_{dialog,narration}.tex), `test_table` (scores_test.tex) and
`data_statistics` (data_statistics.{csv,tex}).  On the device:
`duration_effect` and `duration_effect_scramble` re-encode the val lines
of several runs (`TripletScorer._encode` through `make_predict`) and score
them on the same `random.Random(EVAL_SEED)` rounds
(`comparative_score_triplets`) into results/duration_effect*.pt.
"""

from __future__ import annotations

import logging
import os
from copy import deepcopy
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import yaml

from peppa_tpu_torch.data import dataset as data
from peppa_tpu_torch.data.dataset import PeppaPigDataset, grouped_batches
from peppa_tpu_torch.evaluation.triplet import (TripletScorer,
                                                comparative_score_triplets)
from peppa_tpu_torch.ops.metrics import resampled_recall_at_1_to_n
from peppa_tpu_torch.utils.device import resolve_device

BATCH_SIZE = 8  # reference evaluation.py:21
EVAL_SEED = 666  # reference evaluation.py:18-19


def make_predict(model, device: Optional[Union[str, torch.device]] = None
                 ) -> Callable:
    """A batch (`ClipBatch` or `TripletBatch`, numpy or tensors) -> its
    embeddings (the same type, tensors on the device): the model's eval
    forward under `torch.inference_mode()` on `device` (None: the card;
    raises without CUDA), where the model must already be."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the forward runs on {dev}")

    def run(batch):
        with torch.inference_mode():
            return model(batch.to(model_dev), train=False)

    return run


def resampled_retrieval_score(fragment_type: str, predict_fn: Callable,
                              target_size=(180, 100), duration: float = 2.3,
                              jitter: bool = False,
                              jitter_sd: Optional[float] = None,
                              batch_size: int = BATCH_SIZE,
                              audio_sample_rate: int = 44100,
                              scrambled_video: bool = False,
                              split: Sequence[str] = ("val",),
                              one_to_n: bool = False,
                              data_dir: str = "data",
                              n_samples: int = 500) -> np.ndarray:
    """Bootstrap recall over the clips of one fragment type: recall@0..10
    (n_samples, 11, size) with `one_to_n`, else recall@10
    (n_samples, size); size = min(100, clips)."""
    ds = PeppaPigDataset(
        target_size=target_size, split=list(split),
        fragment_type=fragment_type, duration=duration,
        audio_sample_rate=audio_sample_rate, jitter=jitter,
        jitter_sd=jitter_sd, scrambled_video=scrambled_video,
        data_dir=data_dir)
    vs, as_ = [], []
    for batch in grouped_batches(ds, lambda x: x.audio_duration,
                                 batch_size=batch_size):
        out = predict_fn(batch)
        vs.append(torch.as_tensor(out.video).float())
        as_.append(torch.as_tensor(out.audio).float())
    V, A = torch.cat(vs), torch.cat(as_)
    with torch.inference_mode():
        rec = resampled_recall_at_1_to_n(V, A, seed=EVAL_SEED,
                                         size=min(100, len(V)),
                                         n_samples=n_samples, N=10)
    rec = rec.cpu().numpy()
    return rec if one_to_n else rec[:, 10, :]


def triplet_score(fragment_type: str, predict_fn: Callable,
                  target_size=(180, 100), batch_size: int = BATCH_SIZE,
                  audio_sample_rate: int = 44100, scrambled_video: bool = False,
                  split: Sequence[str] = ("val",), data_dir: str = "data",
                  n_samples: int = 500) -> Dict[str, np.ndarray]:
    """{'accuracy': (n_samples,), 'duration': ...} of the subtitle lines."""
    scorer = TripletScorer(fragment_type=fragment_type, split=split,
                           target_size=target_size,
                           audio_sample_rate=audio_sample_rate,
                           scrambled_video=scrambled_video, data_dir=data_dir)
    return scorer.evaluate(predict_fn, batch_size=batch_size,
                           n_samples=n_samples, seed=EVAL_SEED)


def full_score(model, config, split: Sequence[str] = ("val",),
               data_dir: Optional[str] = None, n_samples: int = 500,
               device: Optional[Union[str, torch.device]] = None
               ) -> List[Dict]:
    """Every standard score of a model (module doc), one row per fragment
    type and scrambling: triplet_acc (n_samples,), recall_fixed and
    recall_jitter (n_samples, 11, size), recall_at_10_fixed and
    recall_at_10_jitter (n_samples, size)."""
    predict_fn = make_predict(model, device)
    data_dir = data_dir or config.data.data_dir
    target_size = config.data.target_size
    sr = config.data.audio_sample_rate
    if list(split) == ["test"]:
        types = ["narration"]
    elif list(split) == ["val"]:
        types = ["dialog", "narration"]
    else:
        raise NotImplementedError(f"split {list(split)}")
    rows = []
    for fragment_type in types:
        for scrambled_video in (False, True):
            logging.info("Evaluating: %s, scramble=%s", fragment_type,
                         scrambled_video)
            acc = triplet_score(fragment_type, predict_fn, target_size,
                                audio_sample_rate=sr,
                                scrambled_video=scrambled_video, split=split,
                                data_dir=data_dir, n_samples=n_samples)
            recall = {}
            for name, jitter, sd in (("fixed", False, None),
                                     ("jitter", True, 0.5)):
                recall[name] = resampled_retrieval_score(
                    fragment_type, predict_fn, target_size, duration=2.3,
                    jitter=jitter, jitter_sd=sd, audio_sample_rate=sr,
                    scrambled_video=scrambled_video, split=split,
                    one_to_n=True, data_dir=data_dir, n_samples=n_samples)
            rows.append(dict(fragment_type=fragment_type,
                             scrambled_video=scrambled_video,
                             triplet_acc=acc["accuracy"],
                             recall_fixed=recall["fixed"],
                             recall_jitter=recall["jitter"],
                             recall_at_10_fixed=recall["fixed"][:, 10, :],
                             recall_at_10_jitter=recall["jitter"][:, 10, :]))
    return rows


# --------------------------------------------------------------- run drivers
def add_condition(rows: List[Dict]) -> List[Dict]:
    """Each row with the condition columns of its run's hparams.yaml
    (reference pig/evaluation.py:229-244)."""
    out = []
    for row in rows:
        record = dict(row)
        with open(row["hparams_path"]) as f:
            config = yaml.safe_load(f)
        record["jitter"] = config["data"]["train"]["jitter"]
        record["static"] = config["video"].get("static", False)
        record["audio_pretrained"] = config["audio"]["pretrained"]
        record["video_pretrained"] = config["video"]["pretrained"]
        record["resolution"] = "x".join(map(str, config["data"]["target_size"]))
        record["freeze_wav2vec"] = (
            config["audio"]["freeze_feature_extractor"]
            and config["audio"].get("freeze_encoder_layers") == 12)
        record["sample_rate"] = str(config["data"].get("audio_sample_rate",
                                                       44100))
        out.append(record)
    return out


def _torch_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path)


def _versions_of(conditions_key: Optional[str] = None,
                 conditions_path: str = "conditions.yaml") -> List:
    with open(conditions_path) as f:
        conditions = yaml.safe_load(f)
    if conditions_key is not None:
        return list(conditions[conditions_key])
    return [v for vals in conditions.values() for v in vals]


def _score_version(version, log_dir: str, split: Sequence[str],
                   n_samples: int, device) -> List[Dict]:
    from peppa_tpu_torch.training.checkpoint import load_best_model

    logging.info("Evaluating version %s", version)
    dirname = os.path.join(log_dir, f"version_{version}")
    model, config, path = load_best_model(dirname, device=device)
    rows = []
    for row in full_score(model, config, split=split, n_samples=n_samples,
                          device=device):
        row["version"] = version
        row["checkpoint_path"] = path
        row["hparams_path"] = os.path.join(dirname, "hparams.yaml")
        rows.append(row)
    return rows


def full_run(versions: Optional[Sequence] = None,
             log_dir: str = "lightning_logs", results_dir: str = "results",
             n_samples: int = 500,
             device: Optional[Union[str, torch.device]] = None,
             conditions_path: str = "conditions.yaml") -> None:
    """Score each run version on val into results/full_scores_v{N}.pt
    (all of conditions.yaml's versions when none are given)."""
    if versions is None:
        versions = _versions_of(conditions_path=conditions_path)
    for version in versions:
        rows = _score_version(version, log_dir, ["val"], n_samples, device)
        _torch_save(add_condition(rows),
                    os.path.join(results_dir, f"full_scores_v{version}.pt"))


def test_run(log_dir: str = "lightning_logs", results_dir: str = "results",
             n_samples: int = 500,
             device: Optional[Union[str, torch.device]] = None,
             conditions_path: str = "conditions.yaml") -> None:
    """Score the base condition's versions on test into
    results/full_test_scores.pt."""
    rows = []
    for version in _versions_of("base", conditions_path):
        rows += _score_version(version, log_dir, ["test"], n_samples, device)
    _torch_save(add_condition(rows),
                os.path.join(results_dir, "full_test_scores.pt"))


# ------------------------------------------------------------------- tables
def score_means(rows: List[Dict]):
    """The bootstrap arrays as means and standard deviations, one
    DataFrame row per result row (reference evaluation.py:55-66)."""
    import pandas as pd

    out = []
    for item in rows:
        row = deepcopy(item)
        acc = np.asarray(row["triplet_acc"])
        row["triplet_acc_std"] = float(acc.std())
        row["triplet_acc"] = float(acc.mean())
        for k in ("recall_at_10_fixed", "recall_at_10_jitter"):
            r = np.asarray(row[k])
            row[k + "_std"] = float(r.mean(axis=1).std())
            row[k] = float(r.mean(axis=1).mean())
        out.append(row)
    return pd.DataFrame.from_records(out)


def pretraining(row) -> str:
    return {(True, True): "AV", (True, False): "A",
            (False, True): "V", (False, False): "None"}[
                row["audio_pretrained"], row["video_pretrained"]]


def merge_scores(versions: Optional[Sequence] = None,
                 results_dir: str = "results") -> None:
    """full_scores_v{N}.pt (the given versions, else every one in
    `results_dir`, sorted by name) concatenated into full_scores.pt."""
    import glob

    if versions is not None:
        paths = [os.path.join(results_dir, f"full_scores_v{v}.pt")
                 for v in versions]
    else:
        paths = sorted(glob.glob(os.path.join(results_dir,
                                              "full_scores_v*.pt")))
    rows = []
    for p in paths:
        rows.extend(torch.load(p, weights_only=False))
    _torch_save(rows, os.path.join(results_dir, "full_scores.pt"))


def format_tables(results_dir: str = "results") -> None:
    """results/full_scores.pt -> scores.csv and
    scores_{dialog,narration}.tex (reference evaluation.py:202-226)."""
    import pandas as pd

    rows = torch.load(os.path.join(results_dir, "full_scores.pt"),
                      weights_only=False)
    rows = add_condition(rows)
    table_all = score_means(rows)
    csv_cols = ["fragment_type", "triplet_acc", "triplet_acc_std",
                "recall_at_10_fixed", "recall_at_10_fixed_std",
                "recall_at_10_jitter", "recall_at_10_jitter_std", "version",
                "checkpoint_path", "hparams_path", "jitter", "static",
                "audio_pretrained", "video_pretrained", "resolution"]
    (table_all[[c for c in csv_cols if c in table_all.columns]]
     .to_csv(os.path.join(results_dir, "scores.csv"), index=False))
    for fragment_type in ("dialog", "narration"):
        table = table_all.query(f"fragment_type=='{fragment_type}'").copy()
        table["pretraining"] = pd.Categorical(
            table.apply(pretraining, axis=1),
            categories=["AV", "A", "V", "None"])
        formatted = (table[["version", "static", "jitter", "pretraining",
                            "resolution", "recall_at_10_fixed",
                            "recall_at_10_jitter", "triplet_acc"]]
                     .sort_values(by=["static", "jitter", "pretraining",
                                      "resolution"])
                     .replace(True, "Yes").replace(False, "")
                     .rename(columns=dict(
                         version="ID", static="Static", jitter="Jitter",
                         pretraining="Pretraining", resolution="Resolution",
                         recall_at_10_fixed="R@10 (fixed)",
                         recall_at_10_jitter="R@10 (jitter)",
                         triplet_acc="Triplet Acc")))
        path = os.path.join(results_dir, f"scores_{fragment_type}.tex")
        formatted.to_latex(buf=path, index=False, float_format="%.3f")


def test_table(results_dir: str = "results") -> None:
    """results/full_test_scores.pt -> scores_test.tex (reference
    evaluation.py:278-291)."""
    import pandas as pd

    rows = torch.load(os.path.join(results_dir, "full_test_scores.pt"),
                      weights_only=False)
    rows = [r for r in rows if not r["scrambled_video"]]
    rf = np.concatenate([np.asarray(r["recall_at_10_fixed"]).mean(axis=1)
                         for r in rows])
    rj = np.concatenate([np.asarray(r["recall_at_10_jitter"]).mean(axis=1)
                         for r in rows])
    acc = np.concatenate([np.asarray(r["triplet_acc"]) for r in rows])
    pd.DataFrame.from_records([{
        "R@10 (fixed)": f"{rf.mean():0.2f} ± {rf.std():0.2f}",
        "R@10 (jitter)": f"{rj.mean():0.2f} ± {rj.std():0.2f}",
        "Triplet Acc": f"{acc.mean():0.2f} ± {acc.std():0.2f}",
    }]).to_latex(buf=os.path.join(results_dir, "scores_test.tex"), index=False)


def data_statistics(results_dir: str = "results", data_dir: str = "data",
                    target_size=(180, 100), durations_fn=None) -> None:
    """Clips and hours per split and fragment type into
    data_statistics.{csv,tex} (reference evaluation.py:23-39).
    `durations_fn(split, fragment_type)` -> the segments' durations
    replaces the scan of the episode tree."""
    import pandas as pd

    if durations_fn is None:
        def durations_fn(split, fragment_type):
            ds = data.PeppaPigIterableDataset(
                target_size=target_size, split=[split],
                fragment_type=fragment_type, duration=2.3, data_dir=data_dir)
            return np.array([s.duration for s in ds._raw_segments()])

    rows = []
    for split in ("train", "val", "test"):
        for fragment_type in ("dialog", "narration"):
            if data.SPLIT_SPEC[fragment_type][split] is None:
                continue
            durations = np.asarray(durations_fn(split, fragment_type))
            rows.append({"Split": split, "Type": fragment_type,
                         "Size (h)": durations.sum() / 3600,
                         "# Clips": len(durations)})
    df = pd.DataFrame.from_records(rows)
    os.makedirs(results_dir, exist_ok=True)
    df.to_csv(os.path.join(results_dir, "data_statistics.csv"),
              index=False, header=True)
    df.to_latex(os.path.join(results_dir, "data_statistics.tex"),
                index=False, header=True, float_format="%.2f")


# ----------------------------------------------------------- duration effect
def _comparative(log_dir: str, model_ids: Sequence, scrambles: Sequence[bool],
                 device) -> List[Dict]:
    """Each fragment type's val lines encoded by every model (loaded in
    `model_ids`' order) for each of `scrambles`, scored on one set of
    rounds: the rows of duration_effect*.pt."""
    from peppa_tpu_torch.training.checkpoint import load_best_model

    encoded = []
    for model_id in model_ids:
        logging.info("Loading version %s", model_id)
        model, config, _ = load_best_model(
            os.path.join(log_dir, f"version_{model_id}"), device=device)
        encoded.append((make_predict(model, device), config))
    out = []
    for fragment_type in ("dialog", "narration"):
        videos, audios, durs = [], [], None
        for scrambled in scrambles:
            for predict_fn, config in encoded:
                scorer = TripletScorer(
                    fragment_type=fragment_type, split=["val"],
                    target_size=config.data.target_size,
                    audio_sample_rate=config.data.audio_sample_rate,
                    scrambled_video=scrambled,
                    data_dir=config.data.data_dir)
                scorer._encode(predict_fn, BATCH_SIZE)
                videos.append(scorer._video)
                audios.append(scorer._audio)
                durs = scorer._duration
        result = comparative_score_triplets(videos, audios, durs,
                                            n_samples=500, seed=EVAL_SEED)
        result["fragment_type"] = fragment_type
        out.append(result)
    return out


def duration_effect(log_dir: str = "lightning_logs",
                    results_dir: str = "results",
                    conditions_path: str = "conditions.yaml",
                    device: Optional[Union[str, torch.device]] = None
                    ) -> None:
    """The pretraining_a and static runs of conditions.yaml on the same
    triplet rounds of each fragment type's val lines: the continuous
    similarity differences of each run and the target durations, into
    results/duration_effect.pt (reference evaluation.py:293-314)."""
    device = resolve_device(device)
    with open(conditions_path) as f:
        conditions = yaml.safe_load(f)
    model_ids = conditions["pretraining_a"] + conditions["static"]
    out = _comparative(log_dir, model_ids, (False,), device)
    for result in out:
        result["model_ids"] = model_ids
    _torch_save(out, os.path.join(results_dir, "duration_effect.pt"))


def duration_effect_scramble(log_dir: str = "lightning_logs",
                             results_dir: str = "results",
                             conditions_path: str = "conditions.yaml",
                             device: Optional[Union[str, torch.device]] = None
                             ) -> None:
    """The base runs of conditions.yaml, each scored on the same rounds
    with intact and with frame-scrambled video, into
    results/duration_effect_scramble.pt (reference evaluation.py:317-337)."""
    device = resolve_device(device)
    with open(conditions_path) as f:
        conditions = yaml.safe_load(f)
    model_ids = conditions["base"]
    out = _comparative(log_dir, model_ids, (False, True), device)
    for result in out:
        result["model_ids"] = model_ids + model_ids
        result["scrambled_video"] = ([False] * len(model_ids)
                                     + [True] * len(model_ids))
    _torch_save(out, os.path.join(results_dir, "duration_effect_scramble.pt"))
