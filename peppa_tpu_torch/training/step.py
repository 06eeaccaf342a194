"""The eval step: encode a `ClipBatch` and score it.

Mirrors `make_eval_step` of peppa_tpu/training/step.py: both towers, then
`triplet_loss` (the fused loss kernel on the card) with the default margin,
as the JAX step does.  The train step comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.utils.device import resolve_device


def eval_step(model, batch: ClipBatch,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V, A, loss) for one batch, under `torch.inference_mode()`, on
    `device` (None: the card; raises without CUDA).  The batch is moved
    there; the model must already be there."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the step runs on {dev}")
    with torch.inference_mode():
        out = model(batch.to(model_dev), train=False)
        loss = triplet_loss(out.video, out.audio)
    return out.video, out.audio, loss
