"""Per-frame ResNet-18 image encoder (the "static" ablation), channels-last
at its public face.

Mirrors peppa_tpu/models/resnet2d.py: every frame is embedded by a 2D
ResNet-18 (stem (7,7) stride 2 -> BN/ReLU -> max pool (3,3) stride 2, then
four stages of two BasicBlocks, widths (64, 128, 256, 512), strides
(1, 2, 2, 2), and a global average over space); the per-frame 512-d
embeddings are pooled over time (attention, or the mean over the valid
frames), projected and L2-normalised.  Frames are folded into the batch:
(B, T, H, W, C) -> (B*T, C, H, W).  BatchNorm has flax's semantics
(`models/layers.py`), under the JAX package's names (no "bn" wrapper).
`quant` runs `stem_conv` and every block's `conv1`, `conv2` and
`downsample` as W8A8 int8 convs (`ops/quant.py`) on the eval path only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from peppa_tpu_torch.models.layers import (AttentionPool, Conv, Dense,
                                           PlainBatchNorm, length_mask)
from peppa_tpu_torch.ops.similarity import l2_normalize


class BasicBlock2D(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int,
                 dtype: torch.dtype, bn_dtype: torch.dtype,
                 quant: bool = False):
        super().__init__()
        s = stride
        self.conv1 = Conv(in_features, features, (3, 3), (s, s), (1, 1),
                          dtype, quant)
        self.bn1 = PlainBatchNorm(features, bn_dtype)
        self.conv2 = Conv(features, features, (3, 3), (1, 1), (1, 1), dtype,
                          quant)
        self.bn2 = PlainBatchNorm(features, bn_dtype)
        self.downsample = self.bn_down = None
        if s != 1 or in_features != features:
            self.downsample = Conv(in_features, features, (1, 1), (s, s),
                                   (0, 0), dtype, quant)
            self.bn_down = PlainBatchNorm(features, bn_dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, train), train))
        out = self.bn2(self.conv2(out, train), train)
        identity = x
        if self.downsample is not None:
            identity = self.bn_down(self.downsample(x, train), train)
        return torch.relu(out + identity)


class ResNet18Trunk(nn.Module):
    """ResNet-18 up to the global average pool: (N, 3, H, W) -> (N, 512)."""

    def __init__(self, dtype: torch.dtype, bn_dtype: torch.dtype,
                 quant: bool = False):
        super().__init__()
        self.stem_conv = Conv(3, 64, (7, 7), (2, 2), (3, 3), dtype, quant)
        self.stem_bn = PlainBatchNorm(64, bn_dtype)
        self.blocks = []
        in_features = 64
        for li, (width, stride) in enumerate(
                zip((64, 128, 256, 512), (1, 2, 2, 2)), 1):
            for bi in range(2):
                name = f"layer{li}_block{bi}"
                self.add_module(name, BasicBlock2D(
                    in_features, width, stride if bi == 0 else 1, dtype,
                    bn_dtype, quant))
                self.blocks.append(name)
                in_features = width

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.stem_bn(self.stem_conv(x, train), train))
        # flax's max_pool pads with -inf, as F.max_pool2d does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return torch.mean(x, dim=(2, 3))


class ImageEncoder(nn.Module):
    """Static video branch: per-frame ResNet-18 -> temporal pool ->
    project -> L2 norm.  `mean`/`std` default to the ImageNet statistics
    (the pretrained case)."""

    # the JAX package names this pool explicitly (flax auto-names the
    # audio tower's): models/convert.py reads it
    JAX_NAMES = {"pool": "pool"}

    def __init__(self, pooling: str = "average", project: bool = True,
                 mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225),
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: Optional[torch.dtype] = None,
                 quant: bool = False):
        super().__init__()
        if pooling not in ("attention", "average"):
            raise ValueError(f"Invalid pooling {pooling}")
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32),
                             persistent=False)
        self.trunk = ResNet18Trunk(dtype, bn_dtype or dtype, quant)
        self.pool = AttentionPool(512, 128) if pooling == "attention" \
            else None
        self.project = Dense(512, 512, dtype) if project else None

    def forward(self, video: torch.Tensor,
                frame_lengths: Optional[torch.Tensor] = None,
                train: bool = False, tap: str = "embedding") -> torch.Tensor:
        b, t, h, w, c = video.shape
        if video.dtype == torch.uint8:
            video = video.float() / 255.0
        x = (video - self.mean.to(video.dtype)) / self.std.to(video.dtype)
        x = x.reshape(b * t, h, w, c).to(self.dtype).permute(0, 3, 1, 2)
        emb = self.trunk(x, train).reshape(b, t, -1)
        if tap == "features":
            return emb
        if self.pool is not None:
            pooled = self.pool(emb, frame_lengths)
        elif frame_lengths is None:
            pooled = torch.mean(emb, dim=1)
        else:
            mask = length_mask(frame_lengths, t).to(emb.dtype)[:, :, None]
            pooled = torch.sum(emb * mask, dim=1) / torch.clamp(
                torch.sum(mask, dim=1), min=1.0)
        if tap == "pooled":
            return pooled
        out = self.project(pooled) if self.project is not None else pooled
        if tap == "projected":
            return out
        return l2_normalize(out.float(), dim=1)
