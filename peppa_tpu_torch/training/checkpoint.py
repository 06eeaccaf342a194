"""Checkpoints: the two best-monitor files and last.ckpt, run directories,
and loading the best model.

Mirrors peppa_tpu/training/checkpoint.py for the port's own checkpoints:

- two monitors, `valnarr_rec_fixed` and `valnarr_triplet`, mode max, the
  best one of each kept as `epoch={e}-{monitor}={score:.2f}.ckpt`, plus
  `last.ckpt` after every validation;
- each `.ckpt` has a `.ckpt.json` sidecar with the JAX package's keys
  (monitor, mode, best_model_score, best_model_path, epoch, metrics; for
  last/preempted/emergency files also `epoch_batch_offset` and the
  `monitors` list), which best-model selection and resume read;
- run directories `version_N/{hparams.yaml, metrics.csv, checkpoints/}`.

Format: one `.ckpt` is `torch.save` of `TrainState.state_dict()`,
{"step", "model", "optimizer", "acc_grads"}, read back with
`torch.load(weights_only=True)`.  A save first copies every state tensor
to host memory on the training thread (the next step changes the live
ones), then one background writer serialises the copy once and publishes
every due path: tmp file then `os.replace`, and hard links for the second
and later paths, so a three-way save is one disk write.  At most one save
is in flight.

`load_best_model` also reads the run directories of the JAX package
(flax-msgpack `.ckpt` files with the same sidecars, read by
`training/flax_msgpack.py`) and of the reference (Lightning `.ckpt` files,
ranked by their ModelCheckpoint callback entry, converted by
`models/convert.py::load_peppa_checkpoint`).  The format is decided per
file: a torch zip with a sidecar is the port's, a file that is neither a
zip nor a pickle is the JAX package's (ranked by its sidecar), and a zip
or pickle with no sidecar is Lightning's.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import yaml

from peppa_tpu_torch.config import Config


def _host_copy(tree):
    """`tree` with every tensor copied to host memory (pinned, issued
    asynchronously, for tensors on the card); the caller synchronises.
    PyTorch caches freed pinned blocks, so only the first save pins new
    host memory; later ones reuse the blocks of the one before."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def snapshot(state) -> Dict[str, Any]:
    """`state.state_dict()` copied to host memory: later steps cannot
    change it.  Returns once the copies have landed."""
    payload = _host_copy(state.state_dict())
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return payload


def _publish(payload: Dict[str, Any],
             jobs: Sequence[Tuple[str, Dict[str, Any]]],
             removals: Sequence[str] = ()) -> None:
    """Write one serialised checkpoint to several paths: the first via a
    tmp file and `os.replace`, the others as hard links of it (a rewrite
    always makes a new inode, so linked paths never see another path's
    later content); each path's sidecar beside it."""
    for stale in removals:
        for p in (stale, stale + ".json"):
            if os.path.exists(p):
                os.remove(p)
    first: Optional[str] = None
    for path, meta in jobs:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp~"
        if os.path.exists(tmp):
            os.remove(tmp)
        if first is None:
            torch.save(payload, tmp)
            first = path
        else:
            os.link(first, tmp)
        os.replace(tmp, path)
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)


def _read_meta(path: str) -> Dict[str, Any]:
    if not os.path.exists(path + ".json"):
        return {}
    with open(path + ".json") as f:
        return json.load(f)


def save_checkpoint(path: str, state, meta: Dict[str, Any]) -> None:
    """Snapshot and write `state` to `path` with its sidecar, now."""
    _publish(snapshot(state), [(path, meta)])


def load_checkpoint(path: str, state=None):
    """(payload, meta) of a checkpoint, the payload's tensors on the CPU;
    with `state` given, (state, meta) after loading the payload into it."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = _read_meta(path)
    if state is not None:
        state.load_state_dict(payload)
        return state, meta
    return payload, meta


def load_params(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(the model's state dict: parameters and running statistics, meta),
    without the optimizer."""
    payload, meta = load_checkpoint(path)
    return payload["model"], meta


class CheckpointMonitor:
    """One monitor: keeps the best checkpoint for a metric (mode max)."""

    def __init__(self, dirpath: str, monitor: str, mode: str = "max"):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.best_score: Optional[float] = None
        self.best_path: Optional[str] = None

    def improved(self, score: float) -> bool:
        if self.best_score is None:
            return True
        return (score > self.best_score if self.mode == "max"
                else score < self.best_score)

    def decide(self, metrics: Dict[str, float], epoch: int
               ) -> Optional[Tuple[str, List[str]]]:
        """Update the best-score bookkeeping; (new path, stale paths) if
        this validation improved the monitor, else None.  Writing is the
        caller's, so that saves run on one writer, in order."""
        if self.monitor not in metrics:
            return None
        score = float(metrics[self.monitor])
        if not self.improved(score):
            return None
        removals = [self.best_path] if self.best_path else []
        fname = f"epoch={epoch}-{self.monitor}={score:.2f}.ckpt"
        path = os.path.join(self.dirpath, fname)
        self.best_score = score
        self.best_path = path
        return path, removals

    def meta_dict(self, epoch: int, metrics: Dict[str, float]
                  ) -> Dict[str, Any]:
        return {
            "monitor": self.monitor,
            "mode": self.mode,
            "best_model_score": self.best_score,
            "best_model_path": self.best_path,
            "epoch": epoch,
            "metrics": {k: float(v) for k, v in metrics.items()},
        }


MONITORS = ("valnarr_rec_fixed", "valnarr_triplet")


class CheckpointManager:
    """The two best monitors plus last.ckpt.  Each validation end takes one
    snapshot of the state and hands it to one background writer, which
    writes every due file from it while training goes on; `wait()` joins
    the writes and raises the first failure."""

    def __init__(self, version_dir: str):
        self.ckpt_dir = os.path.join(version_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitors = [CheckpointMonitor(self.ckpt_dir, m)
                         for m in MONITORS]
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []

    def restore_monitor_state(self, monitors_meta) -> None:
        """Restore each monitor's best score from a resumed checkpoint's
        "monitors" list, so a resumed run never demotes an earlier best.
        Only the score carries over: the best path may lie in the earlier
        run's directory, which is never written to."""
        by_name = {m.get("monitor"): m for m in monitors_meta or []}
        for m in self.monitors:
            meta = by_name.get(m.monitor)
            if meta and meta.get("best_model_score") is not None:
                m.best_score = float(meta["best_model_score"])
                logging.info("Resume: restored monitor %s best=%.4f",
                             m.monitor, m.best_score)

    @staticmethod
    def resume_monitors_meta(resume_from: str,
                             resume_meta: Dict[str, Any]
                             ) -> List[Dict[str, Any]]:
        """The monitors list to restore when resuming from `resume_from`:
        a last/preempted/emergency sidecar's own list; for a best-monitor
        file, its sidecar merged with its sibling monitors' sidecars in the
        same directory, so a resume from either best file restores both."""
        if resume_meta.get("monitors"):
            return resume_meta["monitors"]
        if not resume_meta.get("monitor"):
            return []
        metas = {resume_meta["monitor"]: resume_meta}
        for p in sorted(glob.glob(os.path.join(
                os.path.dirname(resume_from), "*.ckpt.json"))):
            try:
                with open(p) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue
            if m.get("monitor") and m["monitor"] not in metas:
                metas[m["monitor"]] = m
        return list(metas.values())

    def monitor_state(self) -> List[Dict[str, Any]]:
        """The best-score bookkeeping, for preempted/emergency sidecars."""
        return [{"monitor": m.monitor, "mode": m.mode,
                 "best_model_score": m.best_score,
                 "best_model_path": m.best_path} for m in self.monitors]

    def on_validation_end(self, state, metrics: Dict[str, float], epoch: int,
                          epoch_batch_offset: int = 0) -> None:
        """`epoch` is the last fully trained epoch; `epoch_batch_offset`
        the micro-steps of epoch + 1 the state has trained besides (a
        validation inside an epoch), recorded in last.ckpt so that a resume
        from it is step-accurate."""
        jobs: List[Tuple[str, Dict[str, Any]]] = []
        removals: List[str] = []
        for m in self.monitors:
            decision = m.decide(metrics, epoch)
            if decision is not None:
                path, stale = decision
                jobs.append((path, m.meta_dict(epoch, metrics)))
                removals.extend(stale)
                logging.info("Saving best %s=%.4f to %s", m.monitor,
                             m.best_score, path)
        jobs.append((os.path.join(self.ckpt_dir, "last.ckpt"), {
            "monitor": None,
            "best_model_score": None,
            "epoch": epoch,
            "epoch_batch_offset": int(epoch_batch_offset),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "monitors": [m.meta_dict(epoch, metrics) for m in self.monitors],
        }))
        # at most one save in flight, enforced before the next snapshot:
        # each holds a host copy of the whole state
        self._reap(block=len(self._pending) >= 1)
        payload = snapshot(state)
        self._pending.append(
            self._executor.submit(_publish, payload, jobs, removals))

    def wait(self) -> None:
        """Join every write in flight; raise the first failure."""
        self._reap(block=True)

    def _reap(self, block: bool) -> None:
        still: List[Future] = []
        for f in self._pending:
            if block or f.done():
                f.result()  # raises if the writer failed
            else:
                still.append(f)
        self._pending = still


def next_version(log_dir: str = "lightning_logs") -> str:
    """Make and return the next `version_N` run directory under
    `log_dir`."""
    os.makedirs(log_dir, exist_ok=True)
    existing = []
    for p in glob.glob(os.path.join(log_dir, "version_*")):
        m = re.match(r".*version_(\d+)$", p)
        if m:
            existing.append(int(m.group(1)))
    version = max(existing) + 1 if existing else 0
    path = os.path.join(log_dir, f"version_{version}")
    os.makedirs(path, exist_ok=True)
    return path


def _comparable(d: Dict[str, Any]) -> Dict[str, Any]:
    d = dict(d)
    d.pop("git_commit", None)
    return d


def find_preempted_checkpoint(config: Config,
                              log_dir: str = "lightning_logs"
                              ) -> Optional[str]:
    """The newest `checkpoints/preempted.ckpt` under `log_dir` of a run
    with the same config (hparams.yaml equal, git_commit aside), or None:
    a requeued job picks up where its preempted predecessor stopped, and
    runs of other configs sharing `log_dir` are left alone."""
    want = _comparable(config.to_dict())
    candidates: List[Tuple[float, str]] = []
    for vdir in glob.glob(os.path.join(log_dir, "version_*")):
        path = os.path.join(vdir, "checkpoints", "preempted.ckpt")
        hparams = os.path.join(vdir, "hparams.yaml")
        if not (os.path.exists(path) and os.path.exists(hparams)):
            continue
        try:
            saved = _comparable(Config.load(hparams).to_dict())
        except (OSError, ValueError, yaml.YAMLError):
            continue  # unreadable or foreign hparams: not a candidate
        if saved == want:
            candidates.append((os.path.getmtime(path), path))
    return max(candidates)[1] if candidates else None


def consume_preempted_checkpoint(path: str) -> None:
    """Mark an auto-resumed preempted.ckpt as used (renamed, kept), so the
    next --auto_resume run of the config starts afresh."""
    for p in (path, path + ".json"):
        if os.path.exists(p):
            os.replace(p, p + ".consumed")


def save_hparams(version_dir: str, config: Config) -> None:
    """hparams.yaml in the run directory: `config.to_dict()` as YAML."""
    config.dump(os.path.join(version_dir, "hparams.yaml"))


def best_checkpoint_in(dirname: str, higher_better: bool = True
                       ) -> Tuple[str, Dict[str, Any]]:
    """The checkpoint of a run directory with the best recorded monitor
    score, and its sidecar."""
    infos = []
    for path in glob.glob(os.path.join(dirname, "checkpoints", "*.ckpt")):
        meta = _read_meta(path)
        if meta.get("best_model_score") is not None:
            infos.append((path, meta))
    if not infos:
        raise FileNotFoundError(f"No scored checkpoints under {dirname}")
    infos.sort(key=lambda x: x[1]["best_model_score"], reverse=higher_better)
    path, meta = infos[0]
    logging.info("Best %s: %s at %s", meta.get("monitor"),
                 meta.get("best_model_score"), path)
    return path, meta


def _is_torch_checkpoint(path: str) -> bool:
    """True for a `torch.save` file: a zip, or a legacy pickle (protocol 2
    magic); False for a flax-msgpack one.  The port's own files are torch
    files too: `checkpoint_format` tells them from Lightning's."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(2) == b"\x80\x02"


def checkpoint_format(path: str) -> str:
    """"port" (a torch file with a sidecar), "lightning" (a torch file
    without one) or "jax" (flax msgpack)."""
    if not _is_torch_checkpoint(path):
        return "jax"
    return "port" if os.path.exists(path + ".json") else "lightning"


def load_jax_params(path: str
                    ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats, meta) of a JAX-package checkpoint, without
    its optimizer state: nested dicts of numpy arrays, as the JAX package's
    `load_params` gives them."""
    from peppa_tpu_torch.training.flax_msgpack import read_checkpoint

    payload = read_checkpoint(path)
    return (payload["params"], payload.get("batch_stats") or {},
            _read_meta(path))


def best_torch_checkpoint_in(dirname: str, higher_better: bool = True
                             ) -> Tuple[str, Dict[str, Any]]:
    """The reference Lightning checkpoint of a run directory with the best
    `best_model_score` in its callbacks entry (keyed by the stubbed
    ModelCheckpoint class, so the entries are scanned for it), and that
    entry.  Where a file of the recorded `best_model_path`'s name lies in
    this directory's checkpoints/, it is the one returned.  Files with a
    sidecar are the port's or the JAX package's and are skipped."""
    from peppa_tpu_torch.models.convert import load_torch_checkpoint

    infos = []
    for path in glob.glob(os.path.join(dirname, "checkpoints", "*.ckpt")):
        if checkpoint_format(path) != "lightning":
            continue
        blob = load_torch_checkpoint(path)
        for item in dict(blob.get("callbacks") or {}).values():
            if isinstance(item, dict) \
                    and item.get("best_model_score") is not None:
                infos.append((path, {
                    "monitor": item.get("monitor"),
                    "best_model_score": float(torch.as_tensor(
                        item["best_model_score"])),
                    "best_model_path": item.get("best_model_path"),
                }))
                break
    if not infos:
        raise FileNotFoundError(f"No scored torch checkpoints under {dirname}")
    infos.sort(key=lambda x: x[1]["best_model_score"], reverse=higher_better)
    path, meta = infos[0]
    recorded = meta.get("best_model_path")
    if recorded:
        local = os.path.join(dirname, "checkpoints", os.path.basename(recorded))
        if os.path.exists(local):
            path = local
    logging.info("Best %s: %s at %s", meta.get("monitor"),
                 meta.get("best_model_score"), path)
    return path, meta


def load_best_model(dirname: str, higher_better: bool = True,
                    device: Optional[Union[str, torch.device]] = None):
    """(model, config, checkpoint path): the model of a run directory's
    best checkpoint, in eval mode on `device` (None: the card; raises
    without CUDA), for the port's, the JAX package's and the reference's
    run directories.  The config is hparams.yaml's; a reference directory
    without one uses the checkpoint's embedded hyper_parameters."""
    from peppa_tpu_torch.models.convert import (load_jax_variables,
                                                load_peppa_checkpoint)
    from peppa_tpu_torch.models.dual_encoder import PeppaPig
    from peppa_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    hparams = os.path.join(dirname, "hparams.yaml")
    try:
        path, _ = best_checkpoint_in(dirname, higher_better)
    except FileNotFoundError:
        path, _ = best_torch_checkpoint_in(dirname, higher_better)
        config = Config.load(hparams) if os.path.exists(hparams) else None
        model, config, _ = load_peppa_checkpoint(path, config, device=dev)
        return model.eval(), config, path
    config = Config.load(hparams)
    model = PeppaPig(config)
    if checkpoint_format(path) == "port":
        model_state, _ = load_params(path)
        model.load_state_dict(model_state)
    else:
        params, batch_stats, _ = load_jax_params(path)
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        load_jax_variables(model, variables)
    return model.eval().to(dev), config, path
