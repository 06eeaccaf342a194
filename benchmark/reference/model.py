"""The dual encoder in plain float32 PyTorch: the benchmark's yardstick.

The published architecture, written from its description and independent of
the measured program (it imports nothing of it):

- audio: wav2vec2-base (Baevski et al. 2020, fairseq `wav2vec_small`): a
  7-layer bias-free conv extractor of 512 channels, (kernel, stride)
  (10,5) (3,2)x4 (2,2)x2, GroupNorm with one group per channel after the
  first conv, exact GELU after each; LayerNorm(512) -> Linear(768); a
  weight-normed grouped positional conv (kernel 128, 16 groups, the
  trailing output dropped), GELU, residual add, LayerNorm; 12 post-norm
  transformer layers (768 wide, 12 heads of 64, FFN 3072, GELU); the
  28-way aux head.  The Peppa Pig model (Nikolaus, Alishahi & Chrupala,
  TACL 2022) pools the aux head's 28 outputs over time by attention
  (per-feature softmax over time of W2 tanh(W1 x), 128 hidden), projects
  to 512 and L2-normalises.
- video: R(2+1)D-18 (Tran et al., CVPR 2018; torchvision `r2plus1d_18`): a
  (1,7,7)/(1,2,2) conv to 45 channels and a (3,1,1) conv to 64, then four
  stages of two BasicBlocks of (2+1)D convs, widths 64/128/256/512,
  strides 1/2/2/2, the mid-plane width of each block
  c_in c_out 27 // (9 c_in + 3 c_out) (rounded to `midplanes_multiple`
  where the configuration sets it), BatchNorm (eps 1e-5) and ReLU; the
  spatial mean, attention pooling over time masked by the valid frames
  (ceil(frames / 8)), Linear(512 -> 512), L2 norm.  Input is uint8
  (B, T, H, W, 3), scaled to [0, 1] and normalised with the Kinetics mean
  and standard deviation.

Weights are a flat dict of float32 tensors named as `param_spec` lists
them.  Training mode runs BatchNorm on the batch's statistics (mean and
biased variance; running statistics are not kept: they do not enter a
training forward) and the audio tower's dropout and layer-drop with masks
the caller draws (`reference/train.py`).  `checkpoint=True` recomputes
each block in the backward pass, which changes no number and lets a
training batch of the benchmark's size fit in float32.  `quant=True`
rounds the input and the weight of every product to int8 (per-tensor
absmax scales, straight-through gradient): the lower precision that the
benchmark's control runs at.  Every entry runs under `plain_float32()`:
TF32 off for matmuls and cuDNN, whatever the process set, and set back
after.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

CONV_LAYERS = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
               (512, 3, 2), (512, 2, 2), (512, 2, 2))
EMBED, HEADS, FFN, AUX = 768, 12, 3072, 28
POS_KERNEL, POS_GROUPS = 128, 16
POOL_HIDDEN = 128
EMBED_OUT = 512
VIDEO_WIDTHS, VIDEO_STRIDES = (64, 128, 256, 512), (1, 2, 2, 2)
VIDEO_T_STRIDE = 8
KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)
EPS = 1e-5

A = "audio_encoder."
W = "audio_encoder.wav2vec2."
V = "video_encoder."
T = "video_encoder.trunk."


def audio_rates(hp: dict) -> Dict[str, float]:
    """wav2vec2-base's dropout rates, or the configuration's one rate for
    all four (`audio.dropout`)."""
    d = hp["audio"].get("dropout")
    if d is not None:
        return {"dropout": d, "attention": d, "activation": d,
                "layer_drop": d}
    return {"dropout": 0.1, "attention": 0.1, "activation": 0.0,
            "layer_drop": 0.05}


def num_layers(hp: dict) -> int:
    n = hp["audio"].get("num_layers")
    return 12 if n is None else int(n)


def midplanes(c_in: int, c_out: int, multiple: Optional[int]) -> int:
    m = (c_in * c_out * 27) // (c_in * 9 + 3 * c_out)
    if multiple:
        m = max(round(m / multiple) * multiple, multiple)
    return m


def _blocks(hp: dict):
    """(name, c_in, c_out, stride, mid) of each video BasicBlock."""
    out, c_in = [], 64
    for li, (width, stride) in enumerate(zip(VIDEO_WIDTHS, VIDEO_STRIDES), 1):
        for bi in range(2):
            s = stride if bi == 0 else 1
            out.append((f"layer{li}_block{bi}", c_in, width, s,
                        midplanes(c_in, width,
                                  hp["video"].get("midplanes_multiple"))))
            c_in = width
    return out


def check_supported(hp: dict) -> None:
    """The reference covers the paper's model; refuse anything else."""
    a, v = hp["audio"], hp["video"]
    want = {"audio.full": (a.get("full", True), True),
            "audio.pooling": (a.get("pooling", "attention"), "attention"),
            "audio.project": (a.get("project", True), True),
            "video.version": (v.get("version", "r2plus1d_18"),
                              "r2plus1d_18"),
            "video.static": (v.get("static", False), False),
            "video.pooling": (v.get("pooling", "attention"), "attention"),
            "video.project": (v.get("project", True), True),
            "video.pretrained": (v.get("pretrained", True), True),
            "audio.freeze_feature_extractor": (
                a.get("freeze_feature_extractor", False), False),
            "audio.freeze_encoder_layers": (a.get("freeze_encoder_layers"),
                                            None),
            "tpu.bn_dtype": (hp.get("tpu", {}).get("bn_dtype"), None)}
    for key, (got, need) in want.items():
        if got != need:
            raise ValueError(f"the reference has no {key}={got!r}")


# ------------------------------------------------------------ parameters
def param_spec(hp: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight and BatchNorm statistic:
    init is "fan_in" (normal, std 1/sqrt(fan in)), "pos" (normal, std
    sqrt(4 / (kernel * 768))), "zeros" or "ones"."""
    check_supported(hp)
    spec = []

    def dense(name, n_in, n_out):
        spec.append((name + ".weight", (n_out, n_in), "fan_in"))
        spec.append((name + ".bias", (n_out,), "zeros"))

    def norm(name, n, stats=False):
        spec.append((name + ".weight", (n,), "ones"))
        spec.append((name + ".bias", (n,), "zeros"))
        if stats:
            spec.append((name + ".running_mean", (n,), "zeros"))
            spec.append((name + ".running_var", (n,), "ones"))

    c_in = 1
    for i, (ch, k, _) in enumerate(CONV_LAYERS):
        spec.append((f"{W}feature_extractor.conv{i}.weight", (ch, c_in, k),
                     "fan_in"))
        c_in = ch
    norm(f"{W}feature_extractor.group_norm", 512)
    norm(f"{W}proj_ln", 512)
    dense(f"{W}proj", 512, EMBED)
    spec.append((f"{W}pos_conv.pos_conv_v",
                 (POS_KERNEL, EMBED // POS_GROUPS, EMBED), "pos"))
    spec.append((f"{W}pos_conv.pos_conv_g", (POS_KERNEL, 1, 1), "ones"))
    spec.append((f"{W}pos_conv.pos_conv_bias", (EMBED,), "zeros"))
    norm(f"{W}encoder_ln", EMBED)
    for i in range(num_layers(hp)):
        p = f"{W}layer{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(p + "attention." + proj, EMBED, EMBED)
        norm(p + "ln1", EMBED)
        dense(p + "ffn_in", EMBED, FFN)
        dense(p + "ffn_out", FFN, EMBED)
        norm(p + "ln2", EMBED)
    dense(f"{W}aux", EMBED, AUX)
    dense(f"{A}pool.hidden", AUX, POOL_HIDDEN)
    dense(f"{A}pool.out", POOL_HIDDEN, AUX)
    dense(f"{A}project", AUX, EMBED_OUT)

    spec.append((f"{T}stem_spatial.weight", (45, 3, 1, 7, 7), "fan_in"))
    norm(f"{T}stem_bn1", 45, True)
    spec.append((f"{T}stem_temporal.weight", (64, 45, 3, 1, 1), "fan_in"))
    norm(f"{T}stem_bn2", 64, True)
    for name, ci, co, s, mid in _blocks(hp):
        p = f"{T}{name}."
        for conv, cin in (("conv1", ci), ("conv2", co)):
            spec.append((f"{p}{conv}.spatial.weight", (mid, cin, 1, 3, 3),
                         "fan_in"))
            norm(f"{p}{conv}.bn_mid", mid, True)
            spec.append((f"{p}{conv}.temporal.weight", (co, mid, 3, 1, 1),
                         "fan_in"))
        norm(p + "bn1", co, True)
        norm(p + "bn2", co, True)
        if s != 1 or ci != co:
            spec.append((p + "downsample.weight", (co, ci, 1, 1, 1),
                         "fan_in"))
            norm(p + "bn_down", co, True)
    dense(f"{V}pool.attn.hidden", 512, POOL_HIDDEN)
    dense(f"{V}pool.attn.out", POOL_HIDDEN, 512)
    dense(f"{V}project", 512, EMBED_OUT)
    return spec


def draw_weights(hp: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of `param_spec` from `seed`, on `device`, in one draw:
    a flat truncated normal (at 2 sigma, scaled to unit variance) carved
    into the random tensors, the rest filled with zeros or ones."""
    spec = param_spec(hp)
    rand = [(n, s, i) for n, s, i in spec if i in ("fan_in", "pos")]
    total = sum(math.prod(s) for _, s, _ in rand)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    flat.mul_(1.0 / 0.87962566103423978)
    out, at = {}, 0
    for name, shape, init in spec:
        if init in ("fan_in", "pos"):
            n = math.prod(shape)
            std = (math.sqrt(1.0 / math.prod(shape[1:])) if init == "fan_in"
                   else math.sqrt(4.0 / (shape[0] * shape[2])))
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        else:
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(
                shape, device=device)
    return out


# ---------------------------------------------------------------- layers
@contextlib.contextmanager
def plain_float32():
    """TF32 off for matmuls and cuDNN inside; the flags as they were
    after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = was


def in_plain_float32(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with plain_float32():
            return fn(*args, **kw)
    return wrapped


def fake_int8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to int8 with one absmax scale, gradient straight
    through."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.detach() / s), -127, 127) * s
    return x + (q - x).detach()


class Ops:
    """The products of the reference, exact or at int8."""

    def __init__(self, quant: bool = False):
        self.quant = quant

    def _q(self, x):
        return fake_int8(x) if self.quant else x

    def linear(self, x, w, b=None):
        return F.linear(self._q(x), self._q(w), b)

    def conv(self, x, w, stride, padding, groups=1):
        fn = {3: F.conv1d, 5: F.conv3d}[x.ndim]
        return fn(self._q(x), self._q(w), None, stride, padding, 1, groups)


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, EPS)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def l2_normalize(x):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=1,
                                                keepdim=True)), min=1e-12)


def attention_pool(p, prefix, x, lengths=None):
    """Per-feature softmax over time of out(tanh(hidden(x))), masked past
    `lengths`; the weighted sum over time."""
    scores = F.linear(torch.tanh(F.linear(x, p[prefix + "hidden.weight"],
                                          p[prefix + "hidden.bias"])),
                      p[prefix + "out.weight"], p[prefix + "out.bias"])
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths[:, None])
        scores = scores.masked_fill(~valid[:, :, None], -math.inf)
    return torch.sum(torch.softmax(scores, dim=1) * x, dim=1)


def conv_frames(samples):
    """Feature frames of the conv extractor for a number of samples."""
    for _, k, s in CONV_LAYERS:
        samples = (samples - k) // s + 1
    return samples


def _run(fn, checkpoint: bool, *args):
    if checkpoint and torch.is_grad_enabled():
        return _checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ----------------------------------------------------------------- audio
@in_plain_float32
def audio_embed(p, hp, audio, ops: Ops, masks=None, checkpoint=False):
    """(B, S) float32 waveforms -> (B, 512) unit embeddings.  `masks`
    (training): {"proj", "enc": (B, T, 768) keeps, "layers": per layer
    {"keep": 0-d, "attn": (B, H, T, T), "res_attn", "act", "res_ffn"}},
    each None where its rate is 0; None: eval."""
    rates = audio_rates(hp)

    def drop(x, keep, rate):
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def extractor(wave):
        x = wave[:, None, :]
        for i, (_, _, s) in enumerate(CONV_LAYERS):
            x = ops.conv(x, p[f"{W}feature_extractor.conv{i}.weight"], s, 0)
            if i == 0:
                x = F.group_norm(x, 512,
                                 p[f"{W}feature_extractor.group_norm.weight"],
                                 p[f"{W}feature_extractor.group_norm.bias"],
                                 EPS)
            x = gelu(x)
        return x.transpose(1, 2)

    x = _run(extractor, checkpoint, audio)
    x = ops.linear(layer_norm(x, p[f"{W}proj_ln.weight"],
                              p[f"{W}proj_ln.bias"]),
                   p[f"{W}proj.weight"], p[f"{W}proj.bias"])
    x = drop(x, masks and masks["proj"], rates["dropout"])
    v, g = p[f"{W}pos_conv.pos_conv_v"], p[f"{W}pos_conv.pos_conv_g"]
    kernel = g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True)
                                + 1e-12)
    pos = ops.conv(x.transpose(1, 2), kernel.permute(2, 1, 0), 1,
                   POS_KERNEL // 2, POS_GROUPS).transpose(1, 2)
    pos = gelu((pos + p[f"{W}pos_conv.pos_conv_bias"])[:, :-1, :])
    x = layer_norm(x + pos, p[f"{W}encoder_ln.weight"],
                   p[f"{W}encoder_ln.bias"])
    x = drop(x, masks and masks["enc"], rates["dropout"])
    b, t, _ = x.shape
    hd = EMBED // HEADS
    for i in range(num_layers(hp)):
        pre = f"{W}layer{i}."
        m = masks["layers"][i] if masks else None

        def layer(x, pre=pre, m=m):
            def proj(name, y):
                return ops.linear(y, p[pre + name + ".weight"],
                                  p[pre + name + ".bias"])
            q = proj("attention.q_proj", x).view(b, t, HEADS, hd)
            k = proj("attention.k_proj", x).view(b, t, HEADS, hd)
            vv = proj("attention.v_proj", x).view(b, t, HEADS, hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
            probs = drop(torch.softmax(logits, dim=-1), m and m["attn"],
                         rates["attention"])
            att = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
            att = proj("attention.out_proj", att.reshape(b, t, EMBED))
            att = drop(att, m and m["res_attn"], rates["dropout"])
            x = layer_norm(x + att, p[pre + "ln1.weight"], p[pre + "ln1.bias"])
            y = drop(gelu(proj("ffn_in", x)), m and m["act"],
                     rates["activation"])
            y = drop(proj("ffn_out", y), m and m["res_ffn"], rates["dropout"])
            return layer_norm(x + y, p[pre + "ln2.weight"],
                              p[pre + "ln2.bias"])

        y = _run(layer, checkpoint, x)
        x = y if m is None or m["keep"] is None else torch.where(m["keep"],
                                                                 y, x)
    logits = ops.linear(x, p[f"{W}aux.weight"], p[f"{W}aux.bias"])
    pooled = attention_pool(p, f"{A}pool.", logits)
    return l2_normalize(ops.linear(pooled, p[f"{A}project.weight"],
                                   p[f"{A}project.bias"]))


# ----------------------------------------------------------------- video
def _bn(p, name, x, train):
    shape = (1, -1, 1, 1, 1)
    if train:
        mean = torch.mean(x, dim=(0, 2, 3, 4))
        var = torch.clamp(torch.mean(x * x, dim=(0, 2, 3, 4)) - mean * mean,
                          min=0.0)
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    return ((x - mean.view(shape)) * (torch.rsqrt(var + EPS)
                                      * p[name + ".weight"]).view(shape)
            + p[name + ".bias"].view(shape))


@in_plain_float32
def video_embed(p, hp, video, frames, train: bool, ops: Ops,
                checkpoint=False):
    """(B, T, H, W, 3) uint8 clips, `frames` (B,) valid frames or None ->
    (B, 512) unit embeddings."""
    mean = torch.tensor(KINETICS_MEAN, device=video.device)
    std = torch.tensor(KINETICS_STD, device=video.device)
    x = ((video.float() / 255.0 - mean) / std).permute(0, 4, 1, 2, 3)

    def stem(x):
        x = ops.conv(x, p[f"{T}stem_spatial.weight"], (1, 2, 2), (0, 3, 3))
        x = torch.relu(_bn(p, f"{T}stem_bn1", x, train))
        x = ops.conv(x, p[f"{T}stem_temporal.weight"], 1, (1, 0, 0))
        return torch.relu(_bn(p, f"{T}stem_bn2", x, train))

    def two_plus_one(x, pre, s):
        x = ops.conv(x, p[pre + ".spatial.weight"], (1, s, s), (0, 1, 1))
        x = torch.relu(_bn(p, pre + ".bn_mid", x, train))
        return ops.conv(x, p[pre + ".temporal.weight"], (s, 1, 1), (1, 0, 0))

    x = _run(stem, checkpoint, x)
    for name, ci, co, s, _ in _blocks(hp):
        pre = f"{T}{name}."

        def block(x, pre=pre, s=s, down=(s != 1 or ci != co)):
            out = torch.relu(_bn(p, pre + "bn1",
                                 two_plus_one(x, pre + "conv1", s), train))
            out = _bn(p, pre + "bn2", two_plus_one(out, pre + "conv2", 1),
                      train)
            if down:
                x = _bn(p, pre + "bn_down",
                        ops.conv(x, p[pre + "downsample.weight"], s, 0),
                        train)
            return torch.relu(out + x)

        x = _run(block, checkpoint, x)
    x = torch.mean(x, dim=(3, 4)).transpose(1, 2)  # (B, T', 512)
    lengths = None
    if frames is not None:
        lengths = torch.clamp((frames + VIDEO_T_STRIDE - 1) // VIDEO_T_STRIDE,
                              min=1)
    pooled = attention_pool(p, f"{V}pool.attn.", x, lengths)
    return l2_normalize(ops.linear(pooled, p[f"{V}project.weight"],
                                   p[f"{V}project.bias"]))


def in_blocks(fn, n: int, block: int):
    """torch.cat of fn(lo, hi) over row blocks of at most `block`."""
    return torch.cat([fn(lo, min(lo + block, n))
                      for lo in range(0, n, block)])


def cosine(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(len(u), len(v)) cosine matrix in float64."""
    u, v = u.double(), v.double()
    u = u / torch.clamp(u.norm(dim=1, keepdim=True), min=1e-12)
    v = v / torch.clamp(v.norm(dim=1, keepdim=True), min=1e-12)
    return u @ v.T


@in_plain_float32
def contrastive_loss(v: torch.Tensor, a: torch.Tensor,
                     margin: float) -> torch.Tensor:
    """The two-way margin loss over the cosine matrix M[i, j] = cos(v_i,
    a_j): hinges max(0, margin + M[i, j] - M[j, j]) and
    max(0, margin + M[i, j] - M[i, i]) summed off the diagonal, over B^2.
    Float64 where the inputs are; differentiable."""
    vn = v / torch.clamp(v.norm(dim=1, keepdim=True), min=1e-12)
    an = a / torch.clamp(a.norm(dim=1, keepdim=True), min=1e-12)
    m = vn @ an.T
    d = torch.diagonal(m)
    c = (torch.clamp(margin + m - d[None, :], min=0.0)
         + torch.clamp(margin + m - d[:, None], min=0.0))
    b = m.shape[0]
    return (c.sum() - torch.diagonal(c).sum()) / (b * b)


def recall_verdicts(v: torch.Tensor, a: torch.Tensor, n: int,
                    tol: float) -> torch.Tensor:
    """For each audio row j: 1 where clip j is certainly among the n
    nearest clips of audio j (cosine, float64), 0 where certainly not, -1
    where a similarity within `tol` of clip j's decides it."""
    s = cosine(a, v)  # s[j, i] = cos(a_j, v_i)
    d = torch.diagonal(s)[:, None]
    off = ~torch.eye(s.shape[0], dtype=torch.bool, device=s.device)
    strictly_above = ((s > d + tol) & off).sum(dim=1)
    maybe_above = ((s > d - tol) & off).sum(dim=1)
    out = torch.full_like(strictly_above, -1)
    out[maybe_above < n] = 1
    out[strictly_above >= n] = 0
    return out
