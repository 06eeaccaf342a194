"""The train and eval steps on a `ClipBatch`.

Mirrors the single-device branch of peppa_tpu/training/step.py:
`train_step` is `make_train_step`'s step (both towers in training mode, the
fused `triplet_loss` with the config's margin, its gradient, one micro-step
of the optimizer); `eval_step` is `make_eval_step`'s (both towers, then
`triplet_loss` with the default margin) on a `ClipBatch`, and
`make_predict_step`'s (the embeddings alone) on a `TripletBatch`.  On the
card the loss is the fused loss kernel and, where the config routes
attention through them, the attention forward and backward kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from peppa_tpu_torch.data.types import ClipBatch, TripletBatch
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.utils.device import resolve_device


def _model_on(model, device) -> torch.device:
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the step runs on {dev}")
    return model_dev


def step_seed(seed: int, step: int) -> int:
    """The random seed of micro-step `step` of a run seeded `seed` (the
    port's `fold_in(rng, state.step)`)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def train_step(state: TrainState, batch: ClipBatch, seed: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step on `batch`, on `device` (None: the card; raises
    without CUDA): the model in training mode, the triplet loss, its
    gradient, then `state.apply_gradients()`.  Dropout and layer-drop draw
    from a generator seeded by `step_seed(seed, state.step)`, so a seed
    gives the same run (the bits cannot match the JAX package's).  The state
    is updated in place and returned with {"train_loss"}."""
    model = state.model
    dev = _model_on(model, device)
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, state.step))
    model.zero_grad(set_to_none=True)
    out = model(batch.to(dev), train=True, generator=gen)
    loss = triplet_loss(out.video, out.audio, margin=model.config.margin)
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
