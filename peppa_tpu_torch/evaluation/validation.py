"""The four-loader validation that gives the checkpoint monitors' metrics.

Mirrors peppa_tpu/evaluation/validation.py:

- loaders 0 and 1 (dialog and narration clips of fixed duration): encode
  and loss, then recall@10 bootstrapped over `n_samples` subsets of `size`
  pairs -> `val_loss`, `val_rec_fixed`, `valnarr_loss`,
  `valnarr_rec_fixed`;
- loaders 2 and 3 (subtitle lines, batched by exact duration): encode, then
  duration-matched triplet accuracy over `n_samples` rounds ->
  `val_triplet`, `valnarr_triplet`.

Every batch goes through `eval_step` (on the card: the attention forward
kernel in the audio tower, the loss kernel) with the host's batch
production and transfer on a prefetch thread.  Embeddings, durations and
losses stay on the device until the loader is done; then the metrics run
on the device and the host fetches what it needs once per loader.
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, Iterable, List, Optional, Union

import torch

from peppa_tpu_torch.evaluation.triplet import score_triplets
from peppa_tpu_torch.ops.metrics import resampled_recall
from peppa_tpu_torch.training.step import eval_step
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.prefetch import Prefetcher


def encode_loader(model, loader: Iterable,
                  device: Optional[Union[str, torch.device]] = None,
                  limit_batches: Optional[int] = None,
                  collect_duration: bool = False,
                  collect_loss: bool = False) -> Dict[str, torch.Tensor]:
    """Run `eval_step` over (the first `limit_batches` batches of) a loader
    on `device` (None: the card; raises without CUDA).  Returns "video" and
    "audio" (N, 512) tensors on the device and, as asked, "duration" (N,)
    and "loss" (the mean of the batch losses, a 0-d tensor; NaN with no
    batch)."""
    dev = resolve_device(device)
    vs, as_, durs, losses = [], [], [], []
    stream = (loader if limit_batches is None
              else itertools.islice(iter(loader), limit_batches))
    prefetcher = Prefetcher(stream, dev, depth=2)
    try:
        for batch in prefetcher:
            v, a, loss = eval_step(model, batch, dev)
            vs.append(v)
            as_.append(a)
            if collect_duration:
                durs.append(batch.audio_duration)
            if collect_loss:
                losses.append(loss)
    finally:
        # leaving early (eval_step raised) must not leave the worker waiting
        prefetcher.close()
    empty = torch.zeros((0, 512), device=dev)
    out = {"video": torch.cat(vs).float() if vs else empty,
           "audio": torch.cat(as_).float() if as_ else empty}
    if collect_duration:
        out["duration"] = (torch.cat(durs) if durs
                           else torch.zeros((0,), device=dev))
    if collect_loss:
        out["loss"] = (torch.stack(losses).float().mean() if losses
                       else torch.tensor(float("nan")))
    return out


def run_validation(model, val_loaders: List[Iterable],
                   device: Optional[Union[str, torch.device]] = None,
                   n_samples: int = 500, size: int = 100,
                   limit_batches: Optional[int] = None,
                   seed: int = 0) -> Dict[str, float]:
    """The six validation metrics of the four loaders (module doc)."""
    dev = resolve_device(device)
    dia, narr, dia3, narr3 = val_loaders
    metrics: Dict[str, float] = {}

    for name, loader in (("val", dia), ("valnarr", narr)):
        enc = encode_loader(model, loader, dev, limit_batches,
                            collect_loss=True)
        metrics[f"{name}_loss"] = enc["loss"].item()
        n = len(enc["video"])
        eff_size = min(size, n)
        if n == 0:
            continue
        if eff_size < size:
            # val_rec_fixed is recall@10 over subsets of exactly `size` = 100
            # pairs; a smaller set gives another chance level (10/eff_size)
            logging.warning(
                "%s_rec_fixed: only %d val clips (<%d); metric is "
                "recall@10-of-%d (chance %.2f), not the reference's "
                "recall@10-of-%d", name, n, size, eff_size,
                min(10 / eff_size, 1.0), size)
        with torch.no_grad():
            rec = resampled_recall(enc["video"], enc["audio"], seed,
                                   size=eff_size, n_samples=n_samples, n=10)
        metrics[f"{name}_rec_fixed"] = rec.mean().item()

    for name, loader in (("val_triplet", dia3), ("valnarr_triplet", narr3)):
        enc = encode_loader(model, loader, dev, limit_batches,
                            collect_duration=True)
        if len(enc["video"]) < 2:
            continue
        try:
            tri = score_triplets(enc["video"], enc["audio"],
                                 enc["duration"].cpu().numpy(),
                                 n_samples=n_samples, seed=seed)
            metrics[name] = float(tri["accuracy"].mean())
        except ValueError as e:
            logging.warning("Triplet scoring failed: %s", e)
    return metrics
