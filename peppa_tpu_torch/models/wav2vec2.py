"""wav2vec2-base audio encoder with the tap points, eval and training.

Mirrors peppa_tpu/models/wav2vec2.py (module names, parameters and the
bf16 precision policy):

- conv feature extractor: 7 bias-free conv1d layers of 512 channels,
  (k, s) = (10,5) (3,2)x4 (2,2)x2, a x320 downsample; GroupNorm(512 groups)
  in float32 after conv0; exact GELU after each layer;
- feature projection: LayerNorm(512) -> Dense(768);
- weight-normed grouped positional conv (k=128, 16 groups, padding 64,
  trailing element trimmed), GELU, residual add, LayerNorm;
- post-norm transformer layers: MHA(768, 12 heads) and FFN(3072) with
  GELU; the LayerNorms return float32, so in bf16 the residual stream is
  float32 and only the Dense layers run in bf16;
- aux head Dense(768 -> 28).

Training (`deterministic=False`) adds the JAX module's dropout (after
`proj`, after `encoder_ln`, on the attention output, after the FFN GELU and
after `ffn_out`, on the attention probabilities) and layer-drop (one
Bernoulli(1 - layer_drop) per layer and forward; the layer runs and
`torch.where` selects, as `jnp.where` does), all drawn from the one
`torch.Generator` the caller passes.  Attention goes through the attention
kernels (`ops/cuda/attention.py`, forward and backward) when the forward is
deterministic or `attention_dropout` is 0; otherwise through the JAX
module's own XLA route (scores, -inf mask, softmax, dropout on the
probabilities, PV), which the dropout mask needs.  The config chooses the
route.

Taps: 'conv' (B, T, 512), 'context' (B, T, 768), 'logits' (B, T, 28).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from peppa_tpu_torch.models.layers import (Conv, Dense, Dropout, GroupNorm,
                                           LayerNorm, length_mask,
                                           make_audio_pool)
from peppa_tpu_torch.ops.cuda.attention import mha_attention
from peppa_tpu_torch.ops.gelu import gelu
from peppa_tpu_torch.ops.similarity import l2_normalize

# (out_channels, kernel, stride) per conv layer of the feature extractor
CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def conv_output_length(samples):
    """Number of conv feature frames for a number of audio samples."""
    length = samples
    for _, k, s in CONV_LAYERS:
        length = (length - k) // s + 1
    return length


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    num_out: int = 28
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    layer_drop: float = 0.05
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16


class ConvFeatureExtractor(nn.Module):
    """7-layer strided conv front end, x320 downsample."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        convs = []
        c_in = 1
        for ch, k, s in CONV_LAYERS:
            convs.append(Conv(c_in, ch, (k,), (s,), (0,), dtype))
            c_in = ch
        for i, conv in enumerate(convs):
            self.add_module(f"conv{i}", conv)
        self.n_layers = len(convs)
        self.group_norm = GroupNorm(CONV_LAYERS[0][0], CONV_LAYERS[0][0])

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        x = waveform[:, None, :]  # (B, 1, S)
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x)
            if i == 0:
                # groups == channels: per-channel norm over time, float32
                x = self.group_norm(x)
            x = gelu(x)
        return x.transpose(1, 2)  # (B, T, 512)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv positional embedding with fairseq's weight-norm split.

    The parameters keep the JAX package's layout: `pos_conv_v` (k, d/g, d),
    `pos_conv_g` (k, 1, 1); the kernel is g * v / ||v|| with the norm over
    (in, out) per kernel position, computed in float32 each call.
    """

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        d, k, g = cfg.embed_dim, cfg.pos_conv_kernel, cfg.pos_conv_groups
        self.kernel, self.groups, self.dtype = k, g, dtype
        self.pos_conv_v = nn.Parameter(torch.empty(k, d // g, d))
        self.pos_conv_g = nn.Parameter(torch.ones(k, 1, 1))
        self.pos_conv_bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, d)
        v = self.pos_conv_v
        norm = torch.sqrt(torch.sum(torch.square(v), dim=(1, 2), keepdim=True)
                          + 1e-12)
        kernel = (self.pos_conv_g * v / norm).to(self.dtype)  # (k, d/g, d)
        out = torch.nn.functional.conv1d(
            x.to(self.dtype).transpose(1, 2), kernel.permute(2, 1, 0), None,
            1, self.kernel // 2, 1, self.groups).transpose(1, 2)
        out = out + self.pos_conv_bias.to(self.dtype)
        if self.kernel % 2 == 0:
            out = out[:, :-1, :]  # even kernel: drop trailing element
        return gelu(out)


class SelfAttention(nn.Module):
    """Multi-head self-attention: the attention kernels when deterministic
    or without attention dropout, else the plain route with dropout on the
    probabilities (module doc)."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        d = cfg.embed_dim
        self.heads = cfg.num_heads
        self.dtype = dtype
        self.q_proj = Dense(d, d, dtype)
        self.k_proj = Dense(d, d, dtype)
        self.v_proj = Dense(d, d, dtype)
        self.out_proj = Dense(d, d, dtype)
        self.attn_dropout = Dropout(cfg.attention_dropout)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        q = self.q_proj(x).view(b, t, self.heads, hd)
        k = self.k_proj(x).view(b, t, self.heads, hd)
        v = self.v_proj(x).view(b, t, self.heads, hd)
        scale = hd ** -0.5
        if deterministic or self.attn_dropout.rate == 0.0:
            out = mha_attention(q, k, v, lengths=lengths, scale=scale)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(),
                                  k.float())
            if lengths is not None:
                mask = length_mask(lengths, t)
                logits = logits.masked_fill(~mask[:, None, None, :],
                                            -math.inf)
            probs = torch.softmax(logits, dim=-1).to(self.dtype)
            probs = self.attn_dropout(probs, False, generator)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out_proj(out.reshape(b, t, d))


class TransformerLayer(nn.Module):
    """Post-norm transformer layer (wav2vec2-base: layer_norm_first=False)."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.attention = SelfAttention(cfg, dtype)
        self.ln1 = LayerNorm(cfg.embed_dim)
        self.ffn_in = Dense(cfg.embed_dim, cfg.ffn_dim, dtype)
        self.ffn_out = Dense(cfg.ffn_dim, cfg.embed_dim, dtype)
        self.ln2 = LayerNorm(cfg.embed_dim)
        self.dropout = Dropout(cfg.dropout)
        self.activation_dropout = Dropout(cfg.activation_dropout)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn = self.attention(x, lengths, deterministic, generator)
        attn = self.dropout(attn, deterministic, generator)
        x = self.ln1(x + attn)
        y = self.activation_dropout(gelu(self.ffn_in(x)), deterministic,
                                    generator)
        y = self.dropout(self.ffn_out(y), deterministic, generator)
        return self.ln2(x + y)


class Wav2Vec2(nn.Module):
    """The wav2vec2-base trunk with tap points.

    `conv_only` builds the feature extractor alone: the JAX package creates
    no transformer parameters for an encoder that only reads the 'conv' tap
    (`full=False`).
    """

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 dtype: torch.dtype = torch.float32, conv_only: bool = False):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractor(dtype)
        if conv_only:
            return
        c = CONV_LAYERS[-1][0]
        self.proj_ln = LayerNorm(c)
        self.proj = Dense(c, cfg.embed_dim, dtype)
        self.pos_conv = ConvPositionalEmbedding(cfg, dtype)
        self.encoder_ln = LayerNorm(cfg.embed_dim)
        self.dropout = Dropout(cfg.dropout)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", TransformerLayer(cfg, dtype))
        self.aux = Dense(cfg.embed_dim, cfg.num_out, dtype)

    def forward(self, waveform: torch.Tensor,
                sample_lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True, tap: str = "logits",
                mask_padding: bool = False,
                generator: Optional[torch.Generator] = None):
        """waveform (B, S) -> (features at `tap`, frame lengths or None).
        Training (`deterministic=False`) draws dropout and layer-drop from
        `generator`."""
        feats = self.feature_extractor(waveform)
        frame_lengths = (conv_output_length(sample_lengths)
                         if sample_lengths is not None else None)
        if tap == "conv":
            return feats, frame_lengths

        x = self.dropout(self.proj(self.proj_ln(feats)), deterministic,
                         generator)
        x = self.encoder_ln(x + self.pos_conv(x))
        x = self.dropout(x, deterministic, generator)
        attn_lengths = frame_lengths if mask_padding else None
        layer_drop = self.cfg.layer_drop
        for i in range(self.cfg.num_layers):
            layer = getattr(self, f"layer{i}")
            if not deterministic and layer_drop > 0:
                keep = torch.rand((), generator=generator,
                                  device=x.device) < 1.0 - layer_drop
                y = layer(x, attn_lengths, deterministic, generator)
                x = torch.where(keep, y, x)
            else:
                x = layer(x, attn_lengths, deterministic, generator)
        if tap == "context":
            return x, frame_lengths

        logits = self.aux(x)
        if tap == "logits":
            return logits, frame_lengths
        raise ValueError(f"Unknown tap {tap!r}")


class Wav2Vec2Encoder(nn.Module):
    """Audio branch: wav2vec2 trunk -> pooling -> projection -> L2 norm.

    `full=True` pools the 28-d aux logits; `full=False` the 512-d conv
    features.  int16 input is scaled by 1/32768 on the device.
    """

    def __init__(self, full: bool = True, pooling: str = "attention",
                 project: bool = True,
                 cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.full = full
        self.wav2vec2 = Wav2Vec2(cfg, dtype, conv_only=not full)
        n_features = cfg.num_out if full else CONV_LAYERS[-1][0]
        self.pool = make_audio_pool(pooling, n_features)
        self.project = Dense(n_features, 512, dtype) if project else None

    def forward(self, waveform: torch.Tensor,
                sample_lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True, tap: str = "embedding",
                mask_padding: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if waveform.ndim == 3:  # (B, 1, S) channel layout
            waveform = waveform[:, 0, :]
        if waveform.dtype == torch.int16:
            waveform = waveform.float() * (1.0 / 32768.0)
        trunk_tap = "logits" if self.full else "conv"
        if tap in ("conv", "context", "logits"):
            trunk_tap = tap
        feats, frame_lengths = self.wav2vec2(waveform, sample_lengths,
                                             deterministic, trunk_tap,
                                             mask_padding, generator)
        if tap in ("conv", "context", "logits"):
            return feats

        pooled = self.pool(feats, frame_lengths if mask_padding else None)
        if tap == "pooled":
            return pooled
        out = self.project(pooled) if self.project is not None else pooled
        if tap == "projected":
            return out
        return l2_normalize(out.float(), dim=1)
