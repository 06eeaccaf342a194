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

Over a data-parallel mesh (`parallel/mesh.py`, `create(..., mesh=)`)
the gradient of the global loss with respect to the replicated parameters
is the SUM over the ranks of each rank's backward (each rank's slab
reaches the loss through its own rows; the gathers' backward already sums
the terms of every rank), so the mean handed to BertAdam is all-reduced
(SUM) once per optimizer step: at k = 8 one reduce of the trained
parameters' float32 gradients in 8 micro-steps (a per-micro-step reduce
gives the same result to rounding at k times the traffic).  Every rank
then takes the same step.  `create` also points the model's BatchNorm
layers at the global batch (`sync_batch_norm`).

`state_dict()` / `load_state_dict()` carry the whole of it: the model's
parameters and buffers (BatchNorm running statistics included), BertAdam's
moments and its per-group optimizer-step counter, the micro-step counter
and the accumulation buffer, so that a checkpoint taken inside an
accumulation group resumes bit for bit in one process.  Over several
ranks the buffer it carries is the global one (the SUM of the ranks'
buffers, what one process on the global batches holds), which each rank
of a resume, on any number of ranks, takes 1/W of: the same optimizer
step to rounding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from peppa_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                           sync_batch_norm)
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
    mesh: Optional[Mesh] = None  # the data-parallel mesh (None: one rank)

    @classmethod
    def create(cls, model: nn.Module, config,
               mesh: Optional[Mesh] = None) -> "TrainState":
        """The state of `model` trained as `config` says: its optimizer,
        freezing and `accumulate_grad_batches`; over `mesh`, with the
        model's BatchNorm statistics taken over the global batch."""
        params = trainable_parameters(
            model, config.audio.freeze_feature_extractor,
            config.audio.freeze_encoder_layers)
        if mesh is not None:
            sync_batch_norm(model, mesh)
        return cls(model=model,
                   optimizer=make_optimizer(config.optimizer,
                                            params.values()),
                   params=params,
                   accumulate=max(1, config.training.accumulate_grad_batches),
                   mesh=mesh)

    def _all_reduce(self, grads: List[torch.Tensor]) -> None:
        """SUM `grads` over the mesh's ranks, in place (none without a
        process group)."""
        if self.mesh is not None and self.mesh.group is not None:
            all_reduce_grads(grads, self.mesh)

    def apply_gradients(self) -> None:
        """Take one micro-step with the gradients in the parameters'
        `.grad` (which it may overwrite)."""
        k = self.accumulate
        if k == 1:
            self._all_reduce([p.grad for p in self.params.values()
                              if p.grad is not None])
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
                self._all_reduce([self.acc_grads[name]
                                  for name in self.params])
                for name, p in self.params.items():
                    p.grad = self.acc_grads[name]
                self.optimizer.step()
                for name, p in self.params.items():
                    p.grad = None
                    self.acc_grads[name].zero_()
        self.step += 1

    def _ranks_mid_group(self) -> bool:
        """Inside an accumulation group of a run over several ranks: each
        rank's buffer holds its own micro-steps' mean, not yet reduced."""
        return (self.mesh is not None and self.mesh.data > 1
                and self.step % self.accumulate != 0)

    def state_dict(self) -> Dict[str, Any]:
        """{"step", "model", "optimizer", "acc_grads"}: the tensors are the
        live ones (copy them before the next step changes them).  Inside
        an accumulation group of a run over several ranks "acc_grads" is
        the SUM of the ranks' buffers, a copy: that takes an all-reduce,
        so every rank calls it."""
        acc_grads = dict(self.acc_grads)
        if self._ranks_mid_group():
            acc_grads = {n: acc_grads[n].clone() for n in self.params}
            self._all_reduce(list(acc_grads.values()))
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "acc_grads": acc_grads}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s content (from any device) in place.  A
        buffer taken inside an accumulation group is the global one, so
        each of W ranks takes 1/W of it."""
        acc_grads = state["acc_grads"]
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        unknown = sorted(acc_grads.keys() - self.params.keys())
        if unknown:
            raise KeyError(f"accumulation buffer of unknown parameters: "
                           f"{unknown}")
        self.acc_grads = {
            name: acc.to(device=self.params[name].device, copy=True)
            for name, acc in acc_grads.items()}
        self.step = int(state["step"])
        if self._ranks_mid_group():
            for acc in self.acc_grads.values():
                acc.div_(self.mesh.data)


def param_count(model: nn.Module) -> int:
    """The number of parameters of `model` (the JAX package's count of its
    "params" tree: BatchNorm's running statistics are not parameters)."""
    return sum(p.numel() for p in model.parameters())
