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

Over a mesh's model axis (`parallel/mesh.py::shard_model`, before
`create`) the parameters `param_shardings` splits, their BertAdam moments
and their accumulation buffers are this rank's slices
(`state_shardings`); BertAdam clips each by the norm of the whole tensor
(`norm_groups`), and the gradient all-reduce runs over the data group
(the ranks of one model index), since the model ranks of a data row
already hold the whole gradient of every replicated parameter.  Those
gradients are then model rank 0's on every rank of the row
(`broadcast_over_model`, once per optimizer step): on the card the ranks'
backward passes of the same rows differ in the last bits (cuDNN's weight
gradients add with atomics), and the row's replicated parameters must
take one step.

`apply_gradients` is the spans `train.accumulate` (the fold),
`train.all_reduce` (over a mesh) and, on an optimizer step,
`train.optimizer` (the hand-off to `.grad`, BertAdam and the cleared
buffer; `utils/profiling.py`).

`state_dict()` / `load_state_dict()` carry the whole of it: the model's
parameters and buffers (BatchNorm running statistics included), BertAdam's
moments and its per-group optimizer-step counter, the micro-step counter
and the accumulation buffer, so that a checkpoint taken inside an
accumulation group resumes bit for bit in one process.  Over several
ranks the buffer it carries is the global one (the SUM of the ranks'
buffers, what one process on the global batches holds), which each rank
of a resume, on any number of ranks, takes 1/W of: the same optimizer
step to rounding.  Over a model axis `state_dict()` gathers each split
tensor whole (every rank calls it) and `load_state_dict()` keeps this
rank's slice of each, so a checkpoint of any mesh resumes on any other
and loads into an unsplit model (the JAX package's `_replicating_snapshot`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from peppa_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                           broadcast_over_model,
                                           gather_model, param_shardings,
                                           slice_model, state_shardings,
                                           sync_batch_norm)
from peppa_tpu_torch.training.optimization import (BertAdam, make_optimizer,
                                                   trainable_parameters)
from peppa_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    model: nn.Module
    optimizer: BertAdam
    params: Dict[str, nn.Parameter]  # the trained (not frozen) parameters
    accumulate: int = 1  # micro-steps per optimizer step
    step: int = 0  # micro-steps taken
    acc_grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    mesh: Optional[Mesh] = None  # the mesh (None: one rank)

    @classmethod
    def create(cls, model: nn.Module, config,
               mesh: Optional[Mesh] = None) -> "TrainState":
        """The state of `model` trained as `config` says: its optimizer,
        freezing and `accumulate_grad_batches`; over `mesh`, with the
        model's BatchNorm statistics taken over the global batch, and over
        a model axis of the model `shard_model` split on it."""
        params = trainable_parameters(
            model, config.audio.freeze_feature_extractor,
            config.audio.freeze_encoder_layers)
        norm_groups = {}
        if mesh is not None:
            sync_batch_norm(model, mesh)
            if mesh.model > 1:
                if getattr(model, "mesh", None) is not mesh:
                    raise ValueError("over a model axis the state takes a "
                                     "model split on it: shard_model(model, "
                                     "mesh) first")
                split = param_shardings(model, mesh)
                norm_groups = {p: mesh.model_group
                               for name, p in params.items()
                               if split[name] is not None}
        return cls(model=model,
                   optimizer=make_optimizer(config.optimizer,
                                            params.values(), norm_groups),
                   params=params,
                   accumulate=max(1, config.training.accumulate_grad_batches),
                   mesh=mesh)

    def _all_reduce(self, grads: Dict[str, torch.Tensor]) -> None:
        """SUM `grads` (by parameter name) over the data axis, in place
        (nothing without a process group); over a model axis, then model
        rank 0's gradient of each parameter the data row holds whole
        (`broadcast_over_model`)."""
        if self.mesh is None or self.mesh.group is None:
            return
        with span("train.all_reduce"):
            all_reduce_grads(list(grads.values()), self.mesh)
            if self.mesh.model > 1:
                split = param_shardings(self.model, self.mesh)
                broadcast_over_model([g for n, g in grads.items()
                                      if split[n] is None], self.mesh)

    def apply_gradients(self) -> None:
        """Take one micro-step with the gradients in the parameters'
        `.grad` (which it may overwrite)."""
        k = self.accumulate
        if k == 1:
            self._all_reduce({n: p.grad for n, p in self.params.items()
                              if p.grad is not None})
            with span("train.optimizer"):
                self.optimizer.step()
        else:
            n = self.step % k
            with span("train.accumulate"):
                for name, p in self.params.items():
                    g = (p.grad.float() if p.grad is not None
                         else torch.zeros_like(p, dtype=torch.float32))
                    acc = self.acc_grads.get(name)
                    if acc is None:
                        acc = self.acc_grads[name] = torch.zeros_like(g)
                    acc.add_((g - acc) / (n + 1))
            if n == k - 1:
                self._all_reduce({name: self.acc_grads[name]
                                  for name in self.params})
                with span("train.optimizer"):
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

    def _split(self) -> Optional[Dict[str, Dict[Any, Optional[int]]]]:
        """`state_shardings` over a model axis, else None."""
        if self.mesh is None or self.mesh.model == 1:
            return None
        return state_shardings(self, self.mesh)

    def state_dict(self) -> Dict[str, Any]:
        """{"step", "model", "optimizer", "acc_grads"}: the tensors are the
        live ones (copy them before the next step changes them).  Inside
        an accumulation group of a run over several ranks "acc_grads" is
        the SUM of the ranks' buffers, a copy: that takes an all-reduce,
        so every rank calls it.  Over a model axis the split tensors are
        gathered whole (copies; collectives too)."""
        acc_grads = dict(self.acc_grads)
        if self._ranks_mid_group():
            acc_grads = {n: acc_grads[n].clone() for n in self.params}
            if self.mesh.group is not None:
                all_reduce_grads(list(acc_grads.values()), self.mesh)
        state = {"step": self.step, "model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "acc_grads": acc_grads}
        split = self._split()
        if split is not None:
            state = _resplit(state, split,
                             lambda t, d: gather_model(t, d, self.mesh))
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s content (from any device) in place.  A
        buffer taken inside an accumulation group is the global one, so
        each of W ranks takes 1/W of it; over a model axis each rank keeps
        its slices of the whole tensors."""
        split = self._split()
        if split is not None:
            state = _resplit(state, split,
                             lambda t, d: slice_model(t, d, self.mesh))
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


def _resplit(state: Dict[str, Any], split, fn) -> Dict[str, Any]:
    """A copy of `state_dict()`'s structure with `fn(tensor, dim)` in
    place of each tensor that `split` (`state_shardings`) splits."""
    def each(tensors, dims):
        return {k: (t if dims.get(k) is None else fn(t, dims[k]))
                for k, t in tensors.items()}

    opt = state["optimizer"]
    return {**state, "model": each(state["model"], split["model"]),
            "optimizer": {**opt, "state": {
                i: each(s, dict.fromkeys(s, split["optimizer"].get(i)))
                for i, s in opt["state"].items()}},
            "acc_grads": each(state["acc_grads"], split["acc_grads"])}


def param_count(model: nn.Module) -> int:
    """The number of parameters of `model` (the JAX package's count of its
    "params" tree: BatchNorm's running statistics are not parameters)."""
    return sum(p.numel() for p in model.parameters())
