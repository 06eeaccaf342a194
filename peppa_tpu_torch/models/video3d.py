"""The VideoResNet family (R(2+1)D-18, R3D-18, MC3-18), channels-last at
its public face.

Mirrors peppa_tpu/models/video3d.py.  Four stages of two BasicBlocks,
widths (64, 128, 256, 512), strides (1, 2, 2, 2), after a stem:

- r2plus1d_18: stem (1,7,7) stride (1,2,2) -> 45 ch -> BN/ReLU -> (3,1,1)
  -> 64 ch -> BN/ReLU; blocks of (2+1)D convs (spatial (1,3,3), BN, ReLU,
  temporal (3,1,1));
- r3d_18: stem (3,7,7) stride (1,2,2) -> 64 ch -> BN/ReLU; blocks of full
  (3,3,3) convs (`Conv3DSimple`);
- mc3_18: the r3d stem and layer 1, then (1,3,3) convs with no temporal
  stride in layers 2-4 (`Conv3DNoTemporal`).

The temporal stride of the trunk is 8 (layers 2-4), 1 for mc3_18; the
video pool's frame lengths are divided by it.  BatchNorm runs on the
running statistics in eval mode; `train=True` uses the batch's and updates
the running ones (`models/layers.py::BatchNorm`).

Input is (B, T, H, W, C) uint8 or float in [0, 1], as in the JAX package;
it is normalised in float32, cast to the model dtype and permuted to
(B, C, T, H, W) inside.  The JAX package's space-to-depth stem is an exact
re-layout of the plain strided conv on the same (t, 7, 7, 3, F) parameter,
so the port runs the plain conv.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from peppa_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                           conv_padding, make_video_pool)
from peppa_tpu_torch.ops.similarity import l2_normalize


def midplanes(c_in: int, c_out: int, multiple: Optional[int] = None) -> int:
    """R(2+1)D intermediate width (Tran et al. 2018), optionally rounded to
    the nearest multiple of `multiple` (at least `multiple`)."""
    m = (c_in * c_out * 3 * 3 * 3) // (c_in * 3 * 3 + 3 * c_out)
    if multiple:
        m = max(round(m / multiple) * multiple, multiple)
    return m


def _conv(c_in: int, c_out: int, kernel: Sequence[int],
          stride: Sequence[int], dtype: torch.dtype) -> Conv:
    return Conv(c_in, c_out, kernel, stride, conv_padding(tuple(kernel)),
                dtype)


class Conv2Plus1D(nn.Module):
    """(1,3,3) spatial conv -> BN -> ReLU -> (3,1,1) temporal conv."""

    def __init__(self, in_features: int, features: int, mid: int,
                 stride: int, dtype: torch.dtype, bn_dtype: torch.dtype):
        super().__init__()
        self.spatial = _conv(in_features, mid, (1, 3, 3), (1, stride, stride),
                             dtype)
        self.bn_mid = BatchNorm(mid, bn_dtype)
        self.temporal = _conv(mid, features, (3, 1, 1), (stride, 1, 1), dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.temporal(torch.relu(self.bn_mid(self.spatial(x), train)))

    @staticmethod
    def downsample_stride(s: int) -> Tuple[int, int, int]:
        return (s, s, s)


class Conv3DSimple(nn.Module):
    """Full (3,3,3) 3D conv."""

    def __init__(self, in_features: int, features: int, mid: int,
                 stride: int, dtype: torch.dtype, bn_dtype: torch.dtype):
        super().__init__()
        self.conv = _conv(in_features, features, (3, 3, 3), (stride,) * 3,
                          dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(x)

    @staticmethod
    def downsample_stride(s: int) -> Tuple[int, int, int]:
        return (s, s, s)


class Conv3DNoTemporal(nn.Module):
    """(1,3,3) spatial-only conv (MC3 layers 2-4)."""

    def __init__(self, in_features: int, features: int, mid: int,
                 stride: int, dtype: torch.dtype, bn_dtype: torch.dtype):
        super().__init__()
        self.conv = _conv(in_features, features, (1, 3, 3),
                          (1, stride, stride), dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(x)

    @staticmethod
    def downsample_stride(s: int) -> Tuple[int, int, int]:
        return (1, s, s)  # no temporal downsampling (torchvision's)


CONV_MAKERS = {
    "r2plus1d_18": [Conv2Plus1D] * 4,
    "r3d_18": [Conv3DSimple] * 4,
    "mc3_18": [Conv3DSimple] + [Conv3DNoTemporal] * 3,
}


def temporal_stride(version: str) -> int:
    """The trunk's stride over frames: T/8 for layers 2-4, 1 for mc3_18."""
    return 1 if version == "mc3_18" else 8


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int,
                 dtype: torch.dtype, bn_dtype: torch.dtype,
                 midplanes_multiple: Optional[int] = None,
                 conv_maker: type = Conv2Plus1D):
        super().__init__()
        # torchvision computes midplanes once per block and uses it for both
        mid = midplanes(in_features, features, midplanes_multiple)
        self.conv1 = conv_maker(in_features, features, mid, stride, dtype,
                                bn_dtype)
        self.bn1 = BatchNorm(features, bn_dtype)
        self.conv2 = conv_maker(features, features, mid, 1, dtype, bn_dtype)
        self.bn2 = BatchNorm(features, bn_dtype)
        self.downsample = self.bn_down = None
        if stride != 1 or in_features != features:
            self.downsample = _conv(in_features, features, (1, 1, 1),
                                    conv_maker.downsample_stride(stride),
                                    dtype)
            self.bn_down = BatchNorm(features, bn_dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x, train), train))
        out = self.bn2(self.conv2(out, train), train)
        identity = x
        if self.downsample is not None:
            identity = self.bn_down(self.downsample(x), train)
        return torch.relu(out + identity)


class VideoResNetTrunk(nn.Module):
    """Stem + layers 1-4 of one VideoResNet version on (B, C, T, H, W)."""

    def __init__(self, dtype: torch.dtype, bn_dtype: torch.dtype,
                 midplanes_multiple: Optional[int] = None,
                 version: str = "r2plus1d_18"):
        super().__init__()
        if version not in CONV_MAKERS:
            raise ValueError(f"Unknown video version {version!r}")
        self.version = version
        if version == "r2plus1d_18":
            self.stem_spatial = Conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                                     dtype)
            self.stem_bn1 = BatchNorm(45, bn_dtype)
            self.stem_temporal = _conv(45, 64, (3, 1, 1), (1, 1, 1), dtype)
            self.stem_bn2 = BatchNorm(64, bn_dtype)
        else:
            self.stem = Conv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), dtype)
            self.stem_bn = BatchNorm(64, bn_dtype)
        self.blocks = []
        in_features = 64
        for li, (width, stride, maker) in enumerate(
                zip((64, 128, 256, 512), (1, 2, 2, 2), CONV_MAKERS[version]),
                1):
            for bi in range(2):
                name = f"layer{li}_block{bi}"
                self.add_module(name, BasicBlock(
                    in_features, width, stride if bi == 0 else 1, dtype,
                    bn_dtype, midplanes_multiple, maker))
                self.blocks.append(name)
                in_features = width

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.version == "r2plus1d_18":
            x = torch.relu(self.stem_bn1(self.stem_spatial(x), train))
            x = torch.relu(self.stem_bn2(self.stem_temporal(x), train))
        else:
            x = torch.relu(self.stem_bn(self.stem(x), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return x  # (B, 512, T', H', W')


class R3DEncoder(nn.Module):
    """Video branch: normalise -> trunk -> pool -> project -> L2 norm."""

    def __init__(self, version: str = "r2plus1d_18",
                 pooling: str = "attention", project: bool = True,
                 mean: Sequence[float] = (0.43216, 0.394666, 0.37645),
                 std: Sequence[float] = (0.22803, 0.22145, 0.216989),
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: Optional[torch.dtype] = None,
                 midplanes_multiple: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.t_stride = temporal_stride(version)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32),
                             persistent=False)
        self.trunk = VideoResNetTrunk(dtype, bn_dtype or dtype,
                                      midplanes_multiple, version)
        self.pool = make_video_pool(pooling)
        self.project = Dense(512, 512, dtype) if project else None

    def forward(self, video: torch.Tensor,
                frame_lengths: Optional[torch.Tensor] = None,
                train: bool = False, tap: str = "embedding") -> torch.Tensor:
        if video.dtype == torch.uint8:
            video = video.float() / 255.0
        x = (video - self.mean.to(video.dtype)) / self.std.to(video.dtype)
        x = self.trunk(x.to(self.dtype).permute(0, 4, 1, 2, 3), train)
        x = x.permute(0, 2, 3, 4, 1)  # channels-last (B, T', H', W', 512)
        if tap == "features":
            return x
        feat_lengths = None
        if frame_lengths is not None:
            # frame lengths survive the trunk's temporal stride
            feat_lengths = torch.clamp(
                (frame_lengths + self.t_stride - 1) // self.t_stride, min=1)
        pooled = self.pool(x, feat_lengths)
        if tap == "pooled":
            return pooled
        out = self.project(pooled) if self.project is not None else pooled
        if tap == "projected":
            return out
        return l2_normalize(out.float(), dim=1)
