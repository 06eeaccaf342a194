"""The training loop.

Mirrors peppa_tpu/training/loop.py:

- hparams.yaml in a new `version_N` run directory, data and model from the
  config (seeded init, then the pretrained hook), optional resume;
- sanity validation (`num_sanity_val_steps` batches a loader, 10 bootstrap
  subsets);
- the epoch loop over `train_batches(epoch)` through a `Prefetcher`, one
  `train_step` per batch (gradient accumulation inside the state), each
  seeded by `step_generators(seed + 1, step, rank)`;
- a finiteness check of every step's loss, one step late so the host does
  not wait on the device, with an emergency checkpoint and
  `NonFiniteLossError`; the embedding-collapse guard on the same losses;
- logging every `log_every_n_steps` micro-steps, with the learning rate of
  the next optimizer step;
- validation and checkpoints at each epoch end, or every
  `val_check_interval` micro-steps and at the end;
- `PEPPA_PROFILE_DIR` and `PEPPA_PROFILE_STEPS` = N: a `torch.profiler`
  trace (`utils/profiling.py::trace`) of micro-steps N to 2N - 1, each a
  `train.step` range over its phases' ranges (`training/step.py`), and
  the `data.wait` ranges between them, written to the directory once the
  device has finished them (or when the fit ends first);
- budgets: `max_steps` (else `optimizer.t_total`) optimizer steps,
  `max_time`, `max_epochs`, `limit_train_batches`, `limit_val_batches`;
- `checkpoints/preempted.ckpt` on a preemption signal;
- step-accurate resume: a checkpoint records the last fully trained epoch
  and the micro-steps trained of the next; the resumed run starts that
  epoch's stream (a function of the seed and the epoch) past them.

Over several processes (`torchrun`, `utils/dist.py`) it trains on the
mesh of `tpu.mesh_shape` (`parallel/mesh.py`): each data row of ranks
takes its slab of every global batch (`data/datamodule.py`), and the train
step gathers the embeddings, synchronises BatchNorm and all-reduces the
gradients over the data axis; over a 'model' axis the model is split
(`shard_model`, after the pretrained hook) and the ranks of a data row
each run their heads and FFN columns of every transformer layer.  Only rank 0 makes `version_N`, hparams.yaml, the metrics and
the checkpoints (the others' run directory is `nonmain_process`, never
made); validation is replicated (every rank runs the same loaders, with no
collective inside); every rank resumes from the same checkpoint.  Every
decision that ends a loop is made alike on every rank, or a rank would
leave while another waits in a collective: the loss (finiteness, collapse)
is the same on every rank, and `max_time` (each rank's clock) and the
preemption guard (a signal to some ranks) are agreed by one small
all-reduce of host flags per micro-step (`parallel/mesh.py::agree`).
`data.extract` and `data.prepare` are refused there: every rank would
write the same corpus files at once, so the corpus is prepared in one
process first.

The JAX package's host-memory watchdog and its device-state recycling
have no counterpart: they exist only for the TPU tunnel.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.evaluation.validation import run_validation
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.parallel.mesh import agree, make_mesh, shard_model
from peppa_tpu_torch.training.checkpoint import (CheckpointManager,
                                                 load_checkpoint,
                                                 next_version,
                                                 save_checkpoint,
                                                 save_hparams)
from peppa_tpu_torch.training.collapse import CollapseDetector
from peppa_tpu_torch.training.loggers import MetricsLogger
from peppa_tpu_torch.training.optimization import schedule_fn
from peppa_tpu_torch.training.preemption import PreemptionGuard
from peppa_tpu_torch.training.state import TrainState, param_count
from peppa_tpu_torch.training.step import train_step
from peppa_tpu_torch.utils import dist
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.prefetch import Prefetcher
from peppa_tpu_torch.utils.profiling import (StepTimer, host_rss_bytes,
                                             trace)


def parse_max_time(value: Optional[str]) -> Optional[float]:
    """'DD:HH:MM:SS' (leading fields may be left out) -> seconds."""
    if not value:
        return None
    parts = [int(p) for p in value.split(":")]
    while len(parts) < 4:
        parts.insert(0, 0)
    d, h, m, s = parts
    return ((d * 24 + h) * 60 + m) * 60 + s


class NonFiniteLossError(RuntimeError):
    """Raised when training hits a non-finite loss (after an emergency
    checkpoint)."""


class _NullLogger:
    """The metrics logger of a rank other than the main one."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, config: Config, log_dir: str = "lightning_logs",
                 version_dir: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """Trains on `device` (None: the card; raises without CUDA) into
        `version_dir`, or a new `version_N` under `log_dir` (on the main
        process; the others write nothing)."""
        self.config = config
        self.device = resolve_device(device)
        self._main = dist.is_main_process()
        if self._main:
            self.version_dir = version_dir or next_version(log_dir)
            self.logger = MetricsLogger(self.version_dir)
        else:
            self.version_dir = version_dir or os.path.join(
                log_dir, "nonmain_process")
            self.logger = _NullLogger()
        self.mesh = make_mesh(config.tpu.mesh_shape, config.tpu.mesh_axes)
        self.timer = StepTimer(warmup_steps=2)
        # set when a preemption signal stopped fit() early (after
        # checkpoints/preempted.ckpt was written)
        self.preempted = False
        # the micro-step at which the collapse guard fired (None: never)
        self.collapsed_at = None
        self._collapse = None
        self._ckpt = None
        self._prefetcher = None

    def fit(self, data, pretrained_loader: Optional[Callable] = None,
            resume_from: Optional[str] = None) -> TrainState:
        """Train on `data` (a `PigData`); `pretrained_loader(model)` may
        load weights into the initialised model; `resume_from` restores a
        checkpoint (such as .../last.ckpt) first.  Returns the state."""
        cfg = self.config
        tcfg = cfg.training
        dev = self.device
        # armed for all of fit: a signal during set-up or sanity validation
        # stops the run cleanly (SIGUSR1 would otherwise end the process)
        guard = PreemptionGuard(cfg.tpu.preempt_signals)
        profile = contextlib.ExitStack()  # the profile window, when open
        try:
            guard.__enter__()
            if self.mesh.data * self.mesh.model > 1 and (cfg.data.extract
                                                         or cfg.data.prepare):
                # every rank would write the same corpus files at once
                raise ValueError(
                    "data.extract and data.prepare write the corpus's "
                    "files: run PigData(config).prepare_data() in one "
                    "process before training over several")
            if self._main:
                save_hparams(self.version_dir, cfg)
            data.prepare_data()
            data.setup()

            model = init_model(cfg, seed=tcfg.seed, device=dev)
            if pretrained_loader is not None:
                pretrained_loader(model)
            logging.info("Model parameters: %.1fM",
                         param_count(model) / 1e6)
            shard_model(model, self.mesh)  # this rank's heads and columns
            state = TrainState.create(model, cfg, self.mesh)
            start_epoch = 0
            resume_offset = 0  # micro-steps already trained in start_epoch
            resume_meta = {}
            if resume_from is not None:
                state, resume_meta = load_checkpoint(resume_from, state)
                # the train stream is a function of (seed, epoch): resume at
                # the epoch after the last fully trained one, past the
                # micro-steps of it already trained
                if isinstance(resume_meta.get("epoch"), int):
                    start_epoch = resume_meta["epoch"] + 1
                resume_offset = int(resume_meta.get("epoch_batch_offset")
                                    or 0)
                logging.info("Resumed from %s at step %d (epoch %d, skipping "
                             "%d already-trained batches)", resume_from,
                             state.step, start_epoch, resume_offset)

            lr_at = schedule_fn(cfg.optimizer.schedule, cfg.optimizer.lr,
                                cfg.optimizer.warmup, cfg.optimizer.t_total)
            step_seed_base = tcfg.seed + 1
            ckpt = self._ckpt = CheckpointManager(self.version_dir,
                                                  write=self._main)
            if resume_from is not None:
                ckpt.restore_monitor_state(
                    CheckpointManager.resume_monitors_meta(resume_from,
                                                           resume_meta))

            if tcfg.num_sanity_val_steps:
                logging.info("Sanity validation (%d batches)",
                             tcfg.num_sanity_val_steps)
                run_validation(state.model, data.val_loaders(), dev,
                               n_samples=10,
                               limit_batches=tcfg.num_sanity_val_steps,
                               seed=tcfg.seed)

            # the loss is the global batch's: W micro-batches of B rows
            rows = cfg.data.train.batch_size * self.mesh.data
            if cfg.tpu.collapse_guard in ("warn", "stop") and rows >= 2:
                self._collapse = CollapseDetector(
                    cfg.margin, rows, window=cfg.tpu.collapse_window)

            max_seconds = parse_max_time(tcfg.max_time)
            max_opt_steps = (tcfg.max_steps if tcfg.max_steps is not None
                             else cfg.optimizer.t_total)
            accum = max(tcfg.accumulate_grad_batches, 1)
            start = time.time()
            micro_step = state.step  # nonzero after a resume
            epoch = start_epoch
            done = False
            timer = self.timer
            profile_dir = os.environ.get("PEPPA_PROFILE_DIR")
            profile_steps = int(os.environ.get("PEPPA_PROFILE_STEPS", "0"))
            pending = None  # (micro_step, metrics) of the previous step
            last_val_step = -1  # the micro-step of the last validation
            # micro_step at the start of the current epoch's stream, so that
            # micro_step - epoch_start_step counts the batches consumed
            epoch_start_step = micro_step - resume_offset

            def validate_and_checkpoint(epoch, micro_step, completed_epoch,
                                        epoch_batch_offset=0) -> None:
                """`completed_epoch` (the last fully trained epoch) and
                `epoch_batch_offset` (micro-steps trained of the next) go
                into the checkpoint; `epoch` labels the log row."""
                nonlocal last_val_step
                last_val_step = micro_step
                metrics = run_validation(
                    state.model, data.val_loaders(), dev, n_samples=500,
                    limit_batches=tcfg.limit_val_batches, seed=tcfg.seed)
                self.logger.log(metrics, step=micro_step, epoch=epoch)
                logging.info("epoch %d validation: %s", epoch,
                             {k: round(v, 4) for k, v in metrics.items()})
                ckpt.on_validation_end(state, metrics, completed_epoch,
                                       epoch_batch_offset=epoch_batch_offset)

            if agree(self.mesh, guard.triggered)[0]:
                # preempted before the first step: save the initial or
                # restored state (with any resume offset) and stop
                self._on_preempted(guard, state, micro_step, epoch,
                                   micro_step - epoch_start_step)
                done = True
            epoch_complete = True  # no epoch entered yet counts as complete
            skip_batches = resume_offset  # only in the first (resumed) epoch
            while not done:
                if tcfg.max_epochs is not None and epoch >= tcfg.max_epochs:
                    break
                stream = data.train_batches(epoch)
                if tcfg.limit_train_batches is not None:
                    stream = itertools.islice(stream,
                                              tcfg.limit_train_batches)
                epoch_start_step = micro_step - skip_batches
                if skip_batches:
                    # past the batches trained before the interruption: made
                    # on the host and dropped, never moved or stepped
                    stream = itertools.islice(stream, skip_batches, None)
                    skip_batches = 0
                prefetcher = self._prefetcher = Prefetcher(
                    stream, dev, cfg.tpu.prefetch)
                epoch_complete = False
                for batch in prefetcher:
                    if profile_dir and micro_step == profile_steps:
                        profile.enter_context(trace(profile_dir))
                        if dev.type == "cuda":  # done before it is written
                            profile.callback(torch.cuda.synchronize, dev)
                    state, metrics = train_step(state, batch,
                                                step_seed_base, dev)
                    micro_step += 1
                    if profile_dir and micro_step == 2 * profile_steps:
                        profile.close()
                        profile_dir = None
                    timer.step(items=int(batch.audio.shape[0])
                               * self.mesh.data)
                    # every step's loss is checked one step late: by the
                    # time this step is issued the previous one is done
                    if pending is not None:
                        self._watchdog(pending[1]["train_loss"].item(),
                                       pending[0], state, epoch)
                    pending = (micro_step, metrics)
                    if micro_step % tcfg.log_every_n_steps == 0:
                        loss = metrics["train_loss"].item()
                        self._watchdog(loss, micro_step, state, epoch)
                        pending = None  # checked
                        self.logger.log(
                            {"train_loss": loss,
                             "lr": float(lr_at(micro_step // accum)),
                             **timer.metrics(),
                             "perf/host_rss_gb": round(
                                 host_rss_bytes() / (1 << 30), 3)},
                            step=micro_step, epoch=epoch)
                        logging.info("epoch %d step %d loss %.4f "
                                     "(%.1f clips/s)", epoch, micro_step,
                                     loss, timer.items_per_sec)
                    # validation every N micro-steps replaces the per-epoch
                    # one when set
                    if tcfg.val_check_interval and \
                            micro_step % tcfg.val_check_interval == 0:
                        validate_and_checkpoint(
                            epoch, micro_step, completed_epoch=epoch - 1,
                            epoch_batch_offset=micro_step - epoch_start_step)
                    if self.collapsed_at is not None \
                            and cfg.tpu.collapse_guard == "stop":
                        logging.warning(
                            "collapse guard: stopping at step %d; the best "
                            "checkpoints hold the pre-collapse optimum",
                            micro_step)
                        done = True
                        break
                    if max_opt_steps is not None \
                            and micro_step // accum >= max_opt_steps:
                        done = True
                        break
                    time_up, preempted = agree(
                        self.mesh, max_seconds is not None
                        and time.time() - start > max_seconds,
                        guard.triggered)
                    if time_up:
                        logging.info("max_time reached, stopping")
                        done = True
                        break
                    if preempted:
                        self._on_preempted(guard, state, micro_step, epoch,
                                           micro_step - epoch_start_step)
                        done = True
                        break
                else:
                    epoch_complete = True
                prefetcher.close()
                if pending is not None:  # the epoch's last step
                    self._watchdog(pending[1]["train_loss"].item(),
                                   pending[0], state, epoch)
                    pending = None
                if self.preempted:
                    break
                # a max_steps/max_time break inside an epoch records
                # epoch - 1 (the last fully trained one) and the offset, so
                # a resume trains the rest of this epoch
                if tcfg.val_check_interval is None:
                    validate_and_checkpoint(
                        epoch, micro_step,
                        completed_epoch=(epoch if epoch_complete
                                         else epoch - 1),
                        epoch_batch_offset=(0 if epoch_complete
                                            else micro_step
                                            - epoch_start_step))
                epoch += 1
                if not done and agree(self.mesh, guard.triggered)[0]:
                    # preempted during validation: the epoch is complete
                    self._on_preempted(guard, state, micro_step, epoch, 0)
                    break
            # step-based validation: validate the final state too when the
            # run ends between interval boundaries; `epoch` is past the last
            # (possibly partial) epoch here
            if tcfg.val_check_interval is not None and not self.preempted \
                    and last_val_step != micro_step and micro_step > 0:
                validate_and_checkpoint(
                    epoch, micro_step,
                    completed_epoch=(epoch - 1 if epoch_complete
                                     else epoch - 2),
                    epoch_batch_offset=(0 if epoch_complete
                                        else micro_step - epoch_start_step))
        finally:
            profile.close()  # a window the loop did not reach the end of
            guard.__exit__(None, None, None)
            # an exception inside an epoch skips the loop's own close
            if self._prefetcher is not None:
                self._prefetcher.close()

        ckpt.wait()  # join the checkpoint writes in flight (re-raises)
        self.logger.close()
        return state

    def _on_preempted(self, guard, state, micro_step: int, epoch: int,
                      epoch_batch_offset: int = 0) -> None:
        """Write checkpoints/preempted.ckpt and mark the run preempted.
        `epoch` is the epoch the loop is in (or, after a complete
        validation, the next one): the sidecar records epoch - 1 as the
        last complete epoch and `epoch_batch_offset` micro-steps trained of
        `epoch`, which a resume skips."""
        path = os.path.join(self.version_dir, "checkpoints", "preempted.ckpt")
        # a rank that saw no signal stops with the ones that did
        signame = guard.signame or "another rank's signal"
        save_checkpoint(path, state, {
            "monitor": None, "epoch": epoch - 1,
            "epoch_batch_offset": int(epoch_batch_offset),
            "monitors": self._ckpt.monitor_state() if self._ckpt else [],
            "reason": f"preempted by {signame} at step {micro_step}"},
            write=self._main)
        logging.info("preemption (%s): resumable state saved to %s, "
                     "stopping", signame, path)
        self.preempted = True

    def _watchdog(self, loss: float, micro_step: int, state,
                  epoch: int) -> None:
        """Stop on a non-finite loss, after an emergency checkpoint; feed a
        finite one to the collapse detector, which only latches
        `collapsed_at` (the loop decides whether to stop)."""
        if np.isfinite(loss):
            if self._collapse is not None and self.collapsed_at is None \
                    and self._collapse.update(loss):
                self.collapsed_at = micro_step
                self.logger.log({"collapse/detected_step": float(micro_step)},
                                step=micro_step, epoch=epoch)
                logging.warning(
                    "embedding collapse detected at step %d: train loss "
                    "pinned at the constant-embedding saddle %.4f "
                    "(= 2*margin*(1-1/B)) for %d consecutive micro-steps "
                    "after having reached %.4f", micro_step,
                    self._collapse.saddle, self._collapse.window,
                    self._collapse.best)
            return
        path = os.path.join(self.version_dir, "checkpoints",
                            "emergency-nonfinite.ckpt")
        save_checkpoint(path, state, {
            "monitor": None, "epoch": epoch,
            "monitors": self._ckpt.monitor_state() if self._ckpt else [],
            "reason": f"non-finite loss at step {micro_step}"},
            write=self._main)
        raise NonFiniteLossError(
            f"non-finite train loss at step {micro_step};"
            f" state saved to {path}")
