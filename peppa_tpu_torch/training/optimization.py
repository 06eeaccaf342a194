"""BertAdam, its learning-rate schedules, and freezing.

Mirrors peppa_tpu/training/optimization.py (the reference's BertAdam):
Adam with

- no bias correction;
- each parameter tensor's gradient clipped to `max_grad_norm` on its own;
- decoupled weight decay added to the update, on every trained parameter;
- the learning rate read from the schedule at the optimizer step *before*
  it is incremented, so the first update uses schedule(0) (which is 0 under
  `warmup_linear`); `t_total=-1` means a constant rate.

Freezing selects parameters by the JAX package's path names
(`audio_encoder/wav2vec2/feature_extractor/*`, `.../layer{i}/*`); a frozen
tensor is left out of the optimizer, so its update is zero and it takes no
decay, as the JAX package's masked transformation gives.  Gradient
accumulation (optax.MultiSteps with `use_grad_mean`) lives in
`training/state.py`.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn


def warmup_cosine(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float) -> float:
    # triangular: peak at warmup*t_total, zero at/after t_total
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


def schedule_fn(schedule: str, lr: float, warmup: float, t_total: int
                ) -> Callable[[int], float]:
    """Scheduled LR at an integer optimizer step (pre-increment)."""
    fct = SCHEDULES[schedule]

    def fn(step: int) -> float:
        if t_total == -1:
            return lr
        return lr * fct(step / t_total, warmup)

    return fn


class BertAdam(torch.optim.Optimizer):
    """The reference update rule (module doc).  `step()` reads each
    parameter's `.grad` (None counts as zero: the decay still applies).
    Moments are float32 like the parameters; the optimizer-step counter is
    kept per parameter group as `group["step"]`."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 warmup: float = 0.1, t_total: int = 15000,
                 schedule: str = "warmup_linear", b1: float = 0.9,
                 b2: float = 0.999, e: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        if schedule not in SCHEDULES:
            raise ValueError(f"Invalid schedule parameter: {schedule}")
        super().__init__(params, dict(
            lr=lr, warmup=warmup, t_total=t_total, schedule=schedule, b1=b1,
            b2=b2, e=e, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, step=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("BertAdam takes no closure")
        for group in self.param_groups:
            lr_t = schedule_fn(group["schedule"], group["lr"],
                               group["warmup"], group["t_total"])(
                                   group["step"])
            b1, b2, clip = group["b1"], group["b2"], group["max_grad_norm"]
            for p in group["params"]:
                g = (p.grad.float() if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                if clip > 0:
                    norm = torch.sqrt(torch.sum(torch.square(g)))
                    g = g * torch.clamp(clip / torch.clamp(norm, min=1e-12),
                                        max=1.0)
                state = self.state[p]
                if not state:
                    state["m"] = torch.zeros_like(p, dtype=torch.float32)
                    state["v"] = torch.zeros_like(p, dtype=torch.float32)
                m = state["m"].mul_(b1).add_((1 - b1) * g)
                v = state["v"].mul_(b2).add_((1 - b2) * g * g)
                upd = m / (torch.sqrt(v) + group["e"])
                if group["weight_decay"] > 0:
                    upd = upd + group["weight_decay"] * p
                p.add_((-lr_t * upd).to(p.dtype))
            group["step"] += 1


# ------------------------------------------------------------------ freezing

def freeze_patterns(freeze_feature_extractor: bool,
                    freeze_encoder_layers: Optional[int]) -> Sequence[str]:
    """Path glob patterns of the frozen parameter subtrees: the conv feature
    extractor and/or the first N transformer layers of the audio trunk."""
    pats = []
    if freeze_feature_extractor:
        pats.append("audio_encoder/wav2vec2/feature_extractor/*")
    if freeze_encoder_layers:
        for i in range(freeze_encoder_layers):
            pats.append(f"audio_encoder/wav2vec2/layer{i}/*")
    return pats


def freeze_mask(names: Iterable[str], patterns: Sequence[str]
                ) -> Dict[str, bool]:
    """{name: trainable} for parameter names given as JAX paths
    (`a/b/c`) or PyTorch names (`a.b.c`, matched as `a/b/c`)."""
    return {name: not any(fnmatch.fnmatch(name.replace(".", "/"), pat)
                          for pat in patterns)
            for name in names}


def trainable_parameters(model: nn.Module,
                         freeze_feature_extractor: bool = False,
                         freeze_encoder_layers: Optional[int] = None
                         ) -> Dict[str, nn.Parameter]:
    """The model's parameters that are not frozen, by name."""
    params = dict(model.named_parameters())
    mask = freeze_mask(params, freeze_patterns(freeze_feature_extractor,
                                               freeze_encoder_layers))
    return {name: p for name, p in params.items() if mask[name]}


def make_optimizer(opt_cfg, params: Iterable[torch.Tensor]) -> BertAdam:
    """BertAdam from an `OptimizerConfig` over `params` (the trainable
    ones: see `trainable_parameters`)."""
    return BertAdam(params, lr=opt_cfg.lr, warmup=opt_cfg.warmup,
                    t_total=opt_cfg.t_total, schedule=opt_cfg.schedule,
                    b1=opt_cfg.b1, b2=opt_cfg.b2, e=opt_cfg.e,
                    weight_decay=opt_cfg.weight_decay,
                    max_grad_norm=opt_cfg.max_grad_norm)
