"""The dual audio/video encoder.

Mirrors peppa_tpu/models/dual_encoder.py: the wav2vec2 audio branch and the
video branch (a VideoResNet, or the static per-frame ResNet-18 under
`video.static`), `encode_audio` / `encode_video` with tap points, and the
forward on a `ClipBatch` or a `TripletBatch`.

`tpu.remat_audio` / `tpu.remat_video` (the JAX package's `nn.remat` of the
audio tower, and of the R(2+1)D or static tower) run the tower through
`torch.utils.checkpoint` whenever the call records a graph: its
activations are freed after the forward and recomputed in the backward.
The numbers do not change.  The recompute draws the same dropout and
layer-drop masks as the first run (from copies of the generators, see
`_rematted`) and leaves BatchNorm's running statistics alone
(`layers.recomputing`).  A call that records no graph (`eval_step`,
`EncoderService`, the export's tracing: `torch.no_grad()` or
`torch.inference_mode()`) runs the tower as it is.

Each tower call is a span, `model.video` or `model.audio`
(`utils/profiling.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.types import ClipBatch, TripletBatch
from peppa_tpu_torch.models.layers import Conv, Dense, recomputing
from peppa_tpu_torch.models.normalization import resolve_stats
from peppa_tpu_torch.models.resnet2d import ImageEncoder
from peppa_tpu_torch.models.video3d import R3DEncoder
from peppa_tpu_torch.models.wav2vec2 import (ConvPositionalEmbedding,
                                             Wav2Vec2Config, Wav2Vec2Encoder)
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.profiling import span


def dtype_of(precision: str) -> torch.dtype:
    return (torch.bfloat16 if precision in ("bf16", "16", "bfloat16")
            else torch.float32)


def _rematted(fn: Callable, args: tuple,
              generators: Sequence[Optional[torch.Generator]] = ()):
    """`fn(*args, *generators)` through `torch.utils.checkpoint`.

    `checkpoint` restores only the global RNG states for its recompute,
    and the caller's generators have moved on by then: the recompute draws
    from new generators set to the states the caller's had before the
    first run (one copy per distinct generator, so two arguments that are
    one generator stay one stream).  The caller's generators move once, as
    without remat.  The recompute runs under `recomputing()`."""
    states = {id(g): g.get_state() for g in generators if g is not None}
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a, *generators)
        copies = {}
        for g in generators:
            if g is not None and id(g) not in copies:
                copies[id(g)] = torch.Generator(device=g.device)
                copies[id(g)].set_state(states[id(g)])
        with recomputing():
            return fn(*a, *(None if g is None else copies[id(g)]
                            for g in generators))

    return checkpoint(run, *args, use_reentrant=False)


class PeppaPig(nn.Module):
    """Dual encoder, configured from a `Config`."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        quant = config.tpu.quantize_int8  # W8A8 on every tower's eval path
        dtype = dtype_of(config.training.precision)
        audio_kw = {}
        if config.audio.num_layers is not None:
            audio_kw["num_layers"] = config.audio.num_layers
        if config.audio.dropout is not None:
            d = config.audio.dropout
            audio_kw.update(dropout=d, attention_dropout=d,
                            activation_dropout=d, layer_drop=d)
        self.audio_encoder = Wav2Vec2Encoder(
            full=config.audio.full, pooling=config.audio.pooling,
            project=config.audio.project, cfg=Wav2Vec2Config(**audio_kw),
            dtype=dtype, use_pallas=config.tpu.use_pallas, quant=quant)
        bn_dtype = (getattr(torch, config.tpu.bn_dtype)
                    if config.tpu.bn_dtype else None)
        if config.video.static:
            norm = "imagenet" if config.video.pretrained else "peppa"
            mean, std = resolve_stats(norm, config.data.data_dir)
            self.video_encoder = ImageEncoder(
                pooling=config.video.pooling, project=config.video.project,
                mean=mean, std=std, dtype=dtype, bn_dtype=bn_dtype,
                quant=quant)
            return
        # kinetics stats if pretrained else peppa
        norm = "kinetics" if config.video.pretrained else "peppa"
        mean, std = resolve_stats(norm, config.data.data_dir)
        self.video_encoder = R3DEncoder(
            version=config.video.version, pooling=config.video.pooling,
            project=config.video.project, mean=mean, std=std, dtype=dtype,
            bn_dtype=bn_dtype,
            midplanes_multiple=config.video.midplanes_multiple, quant=quant)

    def encode_video(self, video: torch.Tensor,
                     frame_lengths: Optional[torch.Tensor] = None,
                     train: bool = False, tap: str = "embedding"
                     ) -> torch.Tensor:
        """Embed (B, T, H, W, C) video to the shared 512-d space."""
        args = (video, frame_lengths, train, tap)
        with span("model.video"):
            if self.config.tpu.remat_video and torch.is_grad_enabled():
                return _rematted(self.video_encoder, args)
            return self.video_encoder(*args)

    def encode_audio(self, audio: torch.Tensor,
                     sample_lengths: Optional[torch.Tensor] = None,
                     train: bool = False, tap: str = "embedding",
                     mask_padding: bool = False,
                     generator: Optional[torch.Generator] = None,
                     layerdrop_generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Embed (B, S) waveforms to the shared 512-d space; training draws
        dropout from `generator` and layer-drop from `layerdrop_generator`
        (None: `generator`)."""
        args = (audio, sample_lengths, not train, tap, mask_padding)
        generators = (generator, layerdrop_generator)
        with span("model.audio"):
            if self.config.tpu.remat_audio and torch.is_grad_enabled():
                return _rematted(self.audio_encoder, args, generators)
            return self.audio_encoder(*args, *generators)

    def forward(self, batch: Union[ClipBatch, TripletBatch],
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                layerdrop_generator: Optional[torch.Generator] = None
                ) -> Union[ClipBatch, TripletBatch]:
        """On a `ClipBatch`: video pooling is masked by `video_frames`;
        audio pooling is not (`mask_padding=False`), as in the JAX package.
        On a `TripletBatch`: the anchor through the audio tower, the
        positive and negative through the video tower, with no lengths.
        `train=True` runs BatchNorm on batch statistics (updating the
        running ones) and the audio tower's dropout and layer-drop, drawn
        from `generator` and `layerdrop_generator` (None: `generator`)."""
        if isinstance(batch, TripletBatch):
            a = self.encode_audio(batch.anchor, train=train,
                                  generator=generator,
                                  layerdrop_generator=layerdrop_generator)
            p = self.encode_video(batch.positive, train=train)
            n = self.encode_video(batch.negative, train=train)
            return TripletBatch(anchor=a, positive=p, negative=n)
        if not isinstance(batch, ClipBatch):
            raise TypeError("expected a ClipBatch or a TripletBatch, got "
                            f"{type(batch).__name__}")
        v = self.encode_video(batch.video, batch.video_frames, train=train)
        a = self.encode_audio(batch.audio, batch.audio_samples, train=train,
                              generator=generator,
                              layerdrop_generator=layerdrop_generator)
        return ClipBatch(video=v, audio=a,
                         video_duration=batch.video_duration,
                         audio_duration=batch.audio_duration,
                         video_frames=batch.video_frames,
                         audio_samples=batch.audio_samples)


def _init_parameters(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded random init with the JAX package's initialisers: LeCun-normal
    (truncated at 2 sigma) kernels, zero biases, unit norm scales, and
    N(0, 4/(k*d)) for the positional conv's `v`."""
    for module in model.modules():
        if isinstance(module, (Dense, Conv)):
            w = module.weight
            fan_in = math.prod(w.shape[1:])
            # flax's truncated normal: stddev / .87962566103423978
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                            generator=gen)
                w.mul_(std)
        elif isinstance(module, ConvPositionalEmbedding):
            k, _, d = module.pos_conv_v.shape
            with torch.no_grad():
                module.pos_conv_v.normal_(0.0, math.sqrt(4.0 / (k * d)),
                                          generator=gen)


def init_model(config: Config, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> PeppaPig:
    """Build the model with seeded random weights, in eval mode, on `device`
    (None: the card; raises without CUDA).  The weights are drawn on the CPU
    from `torch.Generator().manual_seed(seed)`, so a seed gives the same
    weights on every device."""
    dev = resolve_device(device)
    model = PeppaPig(config)
    _init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)
