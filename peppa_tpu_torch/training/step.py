"""The train and eval steps on a `ClipBatch`.

Mirrors peppa_tpu/training/step.py: `train_step` is `make_train_step`'s
step (both towers in training mode, the fused `triplet_loss` with the
config's margin, its gradient, one micro-step of the optimizer), and over
a data-parallel mesh of W > 1 ranks (`TrainState.mesh`) its sharded form:
each rank's batch is its slab of the global batch and the loss is the
global batch's, the same on every rank, `parallel/contrastive.py`'s
`global_negative_loss` under `tpu.global_negative_loss` (the default; no
loss kernel, as the JAX package runs no Pallas loss there), else the fused
`triplet_loss` on the gathered rows.  `eval_step` is `make_eval_step`'s
(both towers, then `triplet_loss` with the default margin) on a
`ClipBatch`, and `make_predict_step`'s (the embeddings alone) on a
`TripletBatch`.  On the card the loss is the fused loss kernel (but under
the global-negative loss) and, where the config routes attention through
them, the attention forward and backward kernels.

A micro-step is the span `train.step` over `train.forward` (the model
call), `train.loss`, `train.backward` and the state's phases
(`training/state.py`; `utils/profiling.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from peppa_tpu_torch.data.types import ClipBatch, TripletBatch
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.parallel.contrastive import global_negative_loss
from peppa_tpu_torch.parallel.mesh import (Mesh, all_gather_rows,
                                           replicated)
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.profiling import span


def _model_on(model, device) -> torch.device:
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the step runs on {dev}")
    return model_dev


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def step_generators(seed: int, step: int, rank: int, device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(dropout, layer-drop) generators of micro-step `step` of a run seeded
    `seed`: the port's `split(fold_in(rng, state.step))`.  The layer-drop
    stream is a function of (seed, step), so the keeps agree on every rank;
    the dropout stream also of `rank`, so no two ranks share masks."""
    return (torch.Generator(device=device).manual_seed(
                _seed(seed, step, 0, rank)),
            torch.Generator(device=device).manual_seed(_seed(seed, step, 1)))


def _loss(v: torch.Tensor, a: torch.Tensor, config,
          mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.data == 1:
        return triplet_loss(v, a, margin=config.margin)
    if config.tpu.global_negative_loss:
        return global_negative_loss(v, a, mesh, margin=config.margin)
    return replicated(triplet_loss(all_gather_rows(v, mesh),
                                   all_gather_rows(a, mesh),
                                   margin=config.margin), mesh)


def train_step(state: TrainState, batch: ClipBatch, seed: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step on `batch`, on `device` (None: the card; raises
    without CUDA): the model in training mode, the triplet loss (over a
    mesh, the global batch's: module doc), its gradient, then
    `state.apply_gradients()`.  Dropout and layer-drop draw from
    `step_generators(seed, state.step, rank)`, so a seed gives the same run
    (the bits cannot match the JAX package's).  The state is updated in
    place and returned with {"train_loss"}."""
    model = state.model
    dev = _model_on(model, device)
    mesh = state.mesh
    with span("train.step"):
        dropout_gen, layerdrop_gen = step_generators(
            seed, state.step, mesh.rank if mesh is not None else 0, dev)
        model.zero_grad(set_to_none=True)
        with span("train.forward"):
            out = model(batch.to(dev), train=True, generator=dropout_gen,
                        layerdrop_generator=layerdrop_gen)
        with span("train.loss"):
            loss = _loss(out.video, out.audio, model.config, mesh)
        with span("train.backward"):
            loss.backward()
        state.apply_gradients()
    return state, {"train_loss": loss.detach()}


def eval_step(model, batch: Union[ClipBatch, TripletBatch],
              device: Optional[Union[str, torch.device]] = None):
    """(V, A, loss) for a `ClipBatch`; for a `TripletBatch`, the
    `TripletBatch` of its embeddings, with no loss.  Under
    `torch.inference_mode()`, on `device` (None: the card; raises without
    CUDA).  The batch is moved there; the model must already be there."""
    model_dev = _model_on(model, device)
    with torch.inference_mode():
        out = model(batch.to(model_dev), train=False)
        if isinstance(out, TripletBatch):
            return out
        loss = triplet_loss(out.video, out.audio)
    return out.video, out.audio, loss
