"""Building blocks and pooling modules of the encoders.

Mirrors peppa_tpu/models/layers.py (the poolers) and
peppa_tpu/models/qlayers.py: `Dense` and `Conv` are the port's `QDense` and
`QConv`, with the same parameters whether or not they are built with
`quant=True`.  Built so, an eval call (`train` False, the default) runs the
W8A8 path of `ops/quant.py` on the uncast input, as the JAX layers do; a
training call runs the float path, bit for bit.  Parameters are float32, as
the JAX package keeps them; on the float path `Dense` and `Conv` cast input
and weights to their compute dtype at call time (bf16 on the bf16 model),
`LayerNorm` and `GroupNorm` compute and return float32, and `BatchNorm`
computes in float32 and returns its dtype, as flax does.  `Dropout` draws
its mask from the `torch.Generator` it is given.  `recomputing()` marks the
second run of a rematerialised tower (`models/dual_encoder.py`), in which
`BatchNorm` leaves its running statistics alone.

Weight layouts are PyTorch's: Linear (out, in), Conv (out, in, *kernel).
`models/convert.py` moves the JAX package's layouts into them.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from peppa_tpu_torch.ops.quant import int8_conv, int8_matmul
from peppa_tpu_torch.parallel.mesh import reduce_over_model


_recompute = threading.local()


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """The forward inside is the recompute of a rematerialised tower: a
    training `BatchNorm` takes the batch's statistics again but does not
    move its running ones a second time.  Per thread (autograd runs a
    CUDA backward, and with it the recompute, on a thread of its own)."""
    before = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = before


def length_mask(lengths: torch.Tensor, size: int) -> torch.Tensor:
    """(B,) valid lengths -> (B, size) boolean mask."""
    pos = torch.arange(size, device=lengths.device)[None, :]
    return pos < lengths[:, None]


class Dense(nn.Module):
    """y = x W^T + b in `dtype`; `dtype=None` computes in float32 (flax's
    promotion of bf16 inputs against float32 parameters).  With `quant`,
    an eval call takes the int8 product and adds the bias in `dtype`
    after it (`QDense`).

    `row_parallel` (a `Mesh`, set by `parallel/mesh.py::shard_model`):
    the weight holds this rank's slice of the input features and `x` this
    rank's slice of the input, so the product is a partial sum: it is
    taken without the bias, summed over the model group in float32 (the
    int8 product sums its int32 accumulators, with the weight and
    activation scales of the whole tensors), cast once, and the bias,
    which every rank holds whole, is added once after the sum."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None, bias: bool = True,
                 quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        self.row_parallel = None
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype or torch.float32
        b = self.bias.to(dt) if self.bias is not None else None
        mesh = self.row_parallel
        if self.quant and not train:
            y = int8_matmul(x, self.weight, dt,
                            None if mesh is None else mesh.model_group)
        elif mesh is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        else:
            y = reduce_over_model(
                F.linear(x.to(dt), self.weight.to(dt)).float(), mesh).to(dt)
        return y + b if b is not None else y


class Conv(nn.Module):
    """Bias-free N-d convolution (N = len(kernel)) on channels-first input.
    With `quant`, an eval call takes the int8 conv (`QConv`)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int], dtype: torch.dtype,
                 quant: bool = False):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dtype = dtype
        self.quant = quant
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, *kernel))
        self._conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[len(kernel)]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.quant and not train:
            return int8_conv(x, self.weight, self.stride, self.padding,
                             self.dtype)
        return self._conv(x.to(self.dtype), self.weight.to(self.dtype),
                          None, self.stride, self.padding)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, float32 in and out."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-5)


class GroupNorm(nn.Module):
    """GroupNorm on (B, C, T), eps 1e-5, float32 in and out."""

    def __init__(self, groups: int, features: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            1e-5)


class BatchNorm(nn.Module):
    """BatchNorm on channels-first input, eps 1e-5: flax 0.12.3's
    `BatchNorm(momentum=0.9, epsilon=1e-5)` as peppa_tpu/models/video3d.py
    wraps it.

    Computes (x - mean) * (rsqrt(var + eps) * scale) + bias in float32 and
    returns `dtype` (flax's order of operations).  Eval mode uses the running
    statistics.  Train mode uses the batch's, in float32: the mean and the
    *biased* variance E[x^2] - E[x]^2 clipped at 0 (flax's
    `use_fast_variance`), and updates the running ones as
    0.9 * running + 0.1 * batch without gradient.  (`F.batch_norm` would
    update `running_var` with the unbiased variance: another function.)

    `moments`, when set (`parallel/mesh.py::sync_batch_norm`), computes
    E[x] and E[x^2] over the global batch of a data-parallel run, as
    flax's `jnp.mean` does under a JAX mesh; the running statistics then
    move alike on every rank.  None (the default): this batch's.

    Inside `recomputing()` (the recompute of a rematerialised tower) train
    mode computes the batch's statistics again, as the gradient needs them,
    and leaves the running ones as the first run left them: they move once
    per recorded forward.
    """

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.moments = None  # (x, dims) -> (E[x], E[x^2]) of more rows

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            axes = (0,) + tuple(range(2, x.ndim))
            xf = x.float()
            if self.moments is None:
                mean = torch.mean(xf, dim=axes)
                mean_sq = torch.mean(xf * xf, dim=axes)
            else:
                mean, mean_sq = self.moments(xf, axes)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if not getattr(_recompute, "on", False):
                with torch.no_grad():
                    self.running_mean.copy_(0.9 * self.running_mean
                                            + 0.1 * mean)
                    self.running_var.copy_(0.9 * self.running_var
                                           + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        y = ((x.float() - mean.view(shape)) * mul.view(shape)
             + self.bias.view(shape))
        return y.to(self.dtype)


class PlainBatchNorm(BatchNorm):
    """`BatchNorm` where the JAX package uses flax's `nn.BatchNorm`
    directly, with no "bn" module around it (the static image encoder):
    the same function, other names in the JAX variables tree."""


class Dropout(nn.Module):
    """flax `nn.Dropout(rate)`: keeps each element with probability
    1 - rate and scales it by 1 / (1 - rate), drawing the mask from
    `generator`; the identity when `deterministic` or rate 0, zeros at
    rate 1."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        """`shard` = (dim, parts, index): `x` is slice `index` of `parts`
        along `dim` of the whole tensor (a rank's heads or FFN columns):
        the whole tensor's mask is drawn and this slice of it kept, so the
        generator moves as without the split and the mask is the
        unsplit run's."""
        if deterministic or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("dropout needs a torch.Generator in training")
        keep_prob = 1.0 - self.rate
        shape = list(x.shape)
        if shard is not None:
            dim, parts, index = shard
            shape[dim] *= parts
        keep = torch.rand(shape, generator=generator,
                          device=x.device) < keep_prob
        if shard is not None:
            keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class AttentionPool(nn.Module):
    """Per-feature soft attention over time.

    alpha = softmax_t(W_out tanh(W_h x)); out = sum_t alpha * x, with the
    softmax over the time axis independently per feature, in float32.
    """

    def __init__(self, features: int, hidden_size: int = 128):
        super().__init__()
        self.hidden = Dense(features, hidden_size)
        self.out = Dense(hidden_size, features)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        scores = self.out(torch.tanh(self.hidden(x)))  # (B, T, D) float32
        if lengths is not None:
            mask = length_mask(lengths, x.shape[1])[:, :, None]
            scores = scores.masked_fill(~mask, -math.inf)
        alpha = torch.softmax(scores.float(), dim=1).to(x.dtype)
        return torch.sum(alpha * x, dim=1)


class AveragePool(nn.Module):
    """The reference's AdaptiveAvgPool2d((size, 1)) quirk: time is binned
    adaptively into `size` bins and the features are averaged."""

    def __init__(self, size: int = 512):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = x.shape[1]
        feat_mean = torch.mean(x, dim=2)  # (B, T)
        idx = torch.arange(self.size, device=x.device)
        starts = torch.floor(idx * t / self.size).long()
        ends = torch.ceil((idx + 1) * t / self.size).long()
        pos = torch.arange(t, device=x.device)
        sel = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])
        weights = sel.to(x.dtype) / torch.clamp(
            sel.sum(dim=1, keepdim=True), min=1).to(x.dtype)
        return torch.einsum("bt,st->bs", feat_mean, weights)


class LastStep(nn.Module):
    """The last (valid) timestep as the clip embedding."""

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is None:
            return x[:, -1, :]
        idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx]


class VideoAveragePool(nn.Module):
    """Global average over (T, H, W) of channels-last (B, T, H, W, C)."""

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is None:
            return torch.mean(x, dim=(1, 2, 3))
        mask = length_mask(lengths, x.shape[1]).to(x.dtype)[:, :, None, None,
                                                            None]
        total = torch.sum(x * mask, dim=(1, 2, 3))
        count = torch.sum(mask, dim=(1, 2, 3)) * x.shape[2] * x.shape[3]
        return total / torch.clamp(count, min=1.0)


class VideoAttentionPool(nn.Module):
    """Spatial mean, then temporal attention, on (B, T, H, W, C)."""

    def __init__(self, features: int = 512, hidden_size: int = 128):
        super().__init__()
        self.attn = AttentionPool(features, hidden_size)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attn(torch.mean(x, dim=(2, 3)), lengths)


def make_audio_pool(pooling: str, n_features: int) -> nn.Module:
    """Audio pooler factory."""
    if pooling == "average":
        return AveragePool(size=n_features)
    if pooling == "attention":
        return AttentionPool(n_features, 128)
    if pooling == "last":
        return LastStep()
    raise ValueError(f"Invalid pooling: {pooling}")


def make_video_pool(pooling: str, features: int = 512) -> nn.Module:
    """Video pooler factory."""
    if pooling == "attention":
        return VideoAttentionPool(features, 128)
    if pooling == "average":
        return VideoAveragePool()
    raise ValueError(f"Invalid pooling {pooling}")


def conv_padding(kernel: Tuple[int, ...]) -> Tuple[int, ...]:
    """Symmetric k//2 padding per axis (the JAX package's `_conv`)."""
    return tuple(k // 2 for k in kernel)
