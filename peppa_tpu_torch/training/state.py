"""Train state: the model, its optimizer, the micro-step counter and the
gradient-accumulation buffer.

Mirrors peppa_tpu/training/state.py with the JAX package's
`make_optimizer` stack around it: freezing, BertAdam, and
`optax.MultiSteps(every_k_schedule=k, use_grad_mean=True)`: each micro-step
folds its gradient into a running mean (acc += (g - acc) / (n + 1), n the
micro-step within the group, as optax's Welford update), and every k-th
micro-step hands the mean to BertAdam and clears the buffer.  Parameters and
moments move only then.  Unlike the JAX state the port's is updated in
place: the model's parameters and running statistics are the state.

`state_dict()` / `load_state_dict()` carry the whole of it: the model's
parameters and buffers (BatchNorm running statistics included), BertAdam's
moments and its per-group optimizer-step counter, the micro-step counter
and the accumulation buffer, so that a checkpoint taken inside an
accumulation group resumes bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch import nn

from peppa_tpu_torch.training.optimization import (BertAdam, make_optimizer,
                                                   trainable_parameters)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: BertAdam
    params: Dict[str, nn.Parameter]  # the trained (not frozen) parameters
    accumulate: int = 1  # micro-steps per optimizer step
    step: int = 0  # micro-steps taken
    acc_grads: Dict[str, torch.Tensor] = field(default_factory=dict)

    @classmethod
    def create(cls, model: nn.Module, config) -> "TrainState":
        """The state of `model` trained as `config` says: its optimizer,
        freezing and `accumulate_grad_batches`."""
        params = trainable_parameters(
            model, config.audio.freeze_feature_extractor,
            config.audio.freeze_encoder_layers)
        return cls(model=model,
                   optimizer=make_optimizer(config.optimizer,
                                            params.values()),
                   params=params,
                   accumulate=max(1, config.training.accumulate_grad_batches))

    def apply_gradients(self) -> None:
        """Take one micro-step with the gradients in the parameters'
        `.grad` (which it may overwrite)."""
        k = self.accumulate
        if k == 1:
            self.optimizer.step()
        else:
            n = self.step % k
            for name, p in self.params.items():
                g = (p.grad.float() if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                acc = self.acc_grads.get(name)
                if acc is None:
                    acc = self.acc_grads[name] = torch.zeros_like(g)
                acc.add_((g - acc) / (n + 1))
            if n == k - 1:
                for name, p in self.params.items():
                    p.grad = self.acc_grads[name]
                self.optimizer.step()
                for name, p in self.params.items():
                    p.grad = None
                    self.acc_grads[name].zero_()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        """{"step", "model", "optimizer", "acc_grads"}: the tensors are the
        live ones (copy them before the next step changes them)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "acc_grads": dict(self.acc_grads)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s content (from any device) in place."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        unknown = sorted(state["acc_grads"].keys() - self.params.keys())
        if unknown:
            raise KeyError(f"accumulation buffer of unknown parameters: "
                           f"{unknown}")
        self.acc_grads = {
            name: acc.to(device=self.params[name].device, copy=True)
            for name, acc in state["acc_grads"].items()}
        self.step = int(state["step"])
