"""The training step in plain float32 PyTorch: masks, loss, accumulation
and BertAdam, independent of the measured program.

- The masks.  A run seeded `seed` draws micro-step `step`'s dropout masks
  from a `torch.Generator` seeded SeedSequence([seed, step, 0, 0]) and its
  layer-drop keeps from one seeded SeedSequence([seed, step, 1]), on the
  device of the batch.  The dropout stream is drawn in the order of the
  forward: after the input projection, after the positional LayerNorm,
  then per transformer layer the attention probabilities (B, H, T, T),
  the attention output, the FFN activation (where its rate is not 0) and
  the FFN output, each `torch.rand(shape) < 1 - rate`; the layer-drop
  stream draws one `torch.rand(()) < 1 - layer_drop` per layer.
- The loss: `model.contrastive_loss(V, A, margin)`.
- Accumulation: the mean of the k micro-steps' gradients.
- BertAdam (the `pytorch-pretrained-bert` rule the paper trains with):
  each tensor's gradient clipped to `max_grad_norm` on its own, then
  m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 with no bias correction,
  and p -= lr_t (m / (sqrt(v) + e) + weight_decay p), lr_t the schedule at
  the optimizer step before it is counted (`warmup_linear`: 0 at step 0,
  lr warmup_linear(1 / t_total) at step 1, so the parameters first move
  in the second step).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import model as ref

MOVED = 1e-3  # a leaf whose first gradient is under this share of the
# median leaf's moves by round-off alone (a key's bias under softmax)


def step_seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def draw_masks(hp: dict, seed: int, step: int, batch: int, frames: int,
               device) -> dict:
    """Micro-step `step`'s dropout and layer-drop masks for a batch of
    `batch` clips of `frames` transformer frames (module doc)."""
    rates = ref.audio_rates(hp)
    drop = torch.Generator(device=device).manual_seed(step_seed(seed, step,
                                                                0, 0))
    keeps = torch.Generator(device=device).manual_seed(step_seed(seed, step,
                                                                 1))

    def mask(shape, rate):
        if rate == 0.0:
            return None
        return torch.rand(shape, generator=drop, device=device) < 1.0 - rate

    row = (batch, frames, ref.EMBED)
    out = {"proj": mask(row, rates["dropout"]),
           "enc": mask(row, rates["dropout"]), "layers": []}
    for _ in range(ref.num_layers(hp)):
        keep = None
        if rates["layer_drop"] > 0:
            keep = (torch.rand((), generator=keeps, device=device)
                    < 1.0 - rates["layer_drop"])
        out["layers"].append({
            "keep": keep,
            "attn": mask((batch, ref.HEADS, frames, frames),
                         rates["attention"]),
            "res_attn": mask(row, rates["dropout"]),
            "act": mask((batch, frames, ref.FFN), rates["activation"]),
            "res_ffn": mask(row, rates["dropout"])})
    return out


def micro_step_loss(p, hp, batch: dict, seed: int, step: int,
                    ops: ref.Ops, checkpoint: bool = True,
                    rows: slice = slice(None)) -> torch.Tensor:
    """The training loss of one micro-step of `batch` ({"video", "audio",
    "video_frames"} on the device) with the masks of `step`.  `rows` keeps
    a part of the batch for the loss (the benchmark's fault check)."""
    frames = int(ref.conv_frames(batch["audio"].shape[1]))
    masks = draw_masks(hp, seed, step, batch["audio"].shape[0], frames,
                       batch["audio"].device)
    v = ref.video_embed(p, hp, batch["video"], batch["video_frames"], True,
                        ops, checkpoint)
    a = ref.audio_embed(p, hp, batch["audio"], ops, masks, checkpoint)
    return ref.contrastive_loss(v[rows], a[rows], float(hp["margin"]))


def warmup_linear(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


def bert_adam_step(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor],
                   moments: Dict[str, Dict[str, torch.Tensor]], t: int,
                   opt: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """BertAdam's optimizer step `t` (from 0), updating `moments` ({name:
    {"m", "v"}}, empty before the first): per tensor the clipped gradient
    {"g"} as the moments take it, and the parameter's change {"dp"}."""
    if opt["schedule"] != "warmup_linear":
        raise ValueError(f"the reference has no schedule {opt['schedule']}")
    lr = (opt["lr"] if opt["t_total"] == -1
          else opt["lr"] * warmup_linear(t / opt["t_total"], opt["warmup"]))
    out = {}
    for name, p in params.items():
        g = grads[name]
        if opt["max_grad_norm"] > 0:
            norm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(opt["max_grad_norm"]
                                / torch.clamp(norm, min=1e-12), max=1.0)
        st = moments.setdefault(name, {"m": torch.zeros_like(g),
                                       "v": torch.zeros_like(g)})
        st["m"] = opt["b1"] * st["m"] + (1 - opt["b1"]) * g
        st["v"] = opt["b2"] * st["v"] + (1 - opt["b2"]) * g * g
        upd = st["m"] / (torch.sqrt(st["v"]) + opt["e"]) \
            + opt["weight_decay"] * p
        out[name] = {"g": g, "dp": -lr * upd}
    return out


@ref.in_plain_float32
def optimizer_steps(hp: dict, weights: Dict[str, torch.Tensor],
                    batches: List[dict], seed: int, ops: ref.Ops,
                    groups: int, rows: slice = slice(None)) -> dict:
    """`groups` accumulation groups of k = len(batches) / groups
    micro-steps from `weights`, each closed by a BertAdam step: {"losses":
    [float] per micro-step, "g": {name: the first group's clipped mean
    gradient}, "dp": {name: the float32 parameter's change over all the
    steps}}, for every trained tensor (BatchNorm statistics are not
    trained).  The change is read from the stored parameters, as the
    program's is: a change of a few units in the last place of a weight
    near 1 rounds alike on both sides."""
    k = len(batches) // groups
    params = {n: w.detach().clone().requires_grad_(True)
              for n, w in weights.items()
              if not n.endswith(("running_mean", "running_var"))}
    p = dict(weights)
    p.update(params)
    moments, first, losses = {}, None, []
    for t in range(groups):
        acc = {n: torch.zeros_like(w) for n, w in params.items()}
        for step in range(t * k, (t + 1) * k):
            loss = micro_step_loss(p, hp, batches[step], seed, step, ops,
                                   True, rows)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            for (n, _), g in zip(params.items(), grads):
                if g is not None:
                    acc[n].add_(g)
            losses.append(float(loss.detach()))
            del loss, grads
        step_out = bert_adam_step({n: w.detach() for n, w in params.items()},
                                  {n: g / k for n, g in acc.items()},
                                  moments, t, hp["optimizer"])
        del acc
        with torch.no_grad():
            for n, w in params.items():
                w.add_(step_out[n]["dp"])
        if first is None:
            first = {n: s["g"] for n, s in step_out.items()}
        del step_out
    with torch.no_grad():
        dp = {n: w.detach() - weights[n] for n, w in params.items()}
    return {"losses": losses, "g": first, "dp": dp}


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float]
              ) -> List[tuple]:
    """(gap, name, prog, ref) of every leaf, the worst first: a leaf's
    |prog - ref| of a norm over the larger of its reference norm and the
    median leaf's."""
    med = float(np.median(list(refn.values())))
    return sorted(((abs(prog[n] - r) / max(r, med, 1e-30), n, prog[n], r)
                   for n, r in refn.items()), reverse=True)


def readings(prog_losses: List[float], prog_g: Dict[str, float],
             prog_dp: Dict[str, float], ref: dict) -> dict:
    """A run's numbers against the reference's (`optimizer_steps`): the
    worst micro-step's loss gap; the first gradient's norm gap (the
    optimizer's first moment) of the worst leaf and of the median leaf,
    over all leaves and over each tower's; and so the gap of the
    parameters' change over the leaves the reference's first gradient
    moves (norm at least MOVED of the median leaf's)."""
    g_ref = norms(ref["g"])
    gaps = leaf_gaps(prog_g, g_ref)
    floor = MOVED * float(np.median(list(g_ref.values())))
    moved = {n: r for n, r in norms(ref["dp"]).items() if g_ref[n] >= floor}
    dgaps = leaf_gaps(prog_dp, moved)
    out = {"loss_gap": loss_gap(prog_losses, ref["losses"])}
    for key, found in (("grad", gaps), ("change", dgaps)):
        out[f"{key}_gap"] = found[0][0]
        out[f"{key}_gap_median"] = float(np.median([g[0] for g in found]))
        for tower in ("audio", "video"):
            mine = [g[0] for g in found
                    if g[1].startswith(tower + "_encoder.")]
            out[f"{key}_gap_{tower}"] = mine[0]
            out[f"{key}_gap_median_{tower}"] = float(np.median(mine))
    out["worst_leaves"] = gaps[:8]
    out["worst_changes"] = dgaps[:8]
    out["unmoved_leaves"] = sorted(set(g_ref) - set(moved))
    return out


def loss_gap(prog: List[float], refl: List[float]) -> float:
    """The worst micro-step's |prog - ref| / |ref|."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, refl))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


