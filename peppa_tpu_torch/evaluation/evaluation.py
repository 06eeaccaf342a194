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
both packages.  The tables and plots (`score_means`, `format_tables`,
`test_table`, `data_statistics`, `duration_effect*`) need pandas and
matplotlib and are not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import yaml

from peppa_tpu_torch.data.dataset import PeppaPigDataset, grouped_batches
from peppa_tpu_torch.evaluation.triplet import TripletScorer
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


def _versions_of(conditions_key: Optional[str] = None) -> List:
    with open("conditions.yaml") as f:
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
             device: Optional[Union[str, torch.device]] = None) -> None:
    """Score each run version on val into results/full_scores_v{N}.pt
    (all of conditions.yaml's versions when none are given)."""
    if versions is None:
        versions = _versions_of()
    for version in versions:
        rows = _score_version(version, log_dir, ["val"], n_samples, device)
        _torch_save(add_condition(rows),
                    os.path.join(results_dir, f"full_scores_v{version}.pt"))


def test_run(log_dir: str = "lightning_logs", results_dir: str = "results",
             n_samples: int = 500,
             device: Optional[Union[str, torch.device]] = None) -> None:
    """Score the base condition's versions on test into
    results/full_test_scores.pt."""
    rows = []
    for version in _versions_of("base"):
        rows += _score_version(version, log_dir, ["test"], n_samples, device)
    _torch_save(add_condition(rows),
                os.path.join(results_dir, "full_test_scores.pt"))
