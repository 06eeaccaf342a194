"""W8A8 dynamic int8 quantization of the serving path's convs and matmuls.

Mirrors peppa_tpu/ops/quant.py, on the port's weight layouts (Linear
(out, in), Conv (out, in, *kernel): the output channel is axis 0).  The
scheme is the JAX package's, value for value:

- weights: per-output-channel absmax scales, max|w| / 127 (clamped at
  1e-12), quantized on every call;
- activations: one dynamic absmax scale over the *whole* tensor, batch and
  padding included, so one clip's int8 embedding depends on the others in
  its batch; symmetric rounding maps 0 to 0, so zero padding stays zero;
- `round(x / s)` (half to even, as `jnp.round`), clipped to +-127;
- int32 accumulation, then `(acc as float32 * (s_x * w_scale))` cast to
  the output dtype, in that order of float operations.

`int8_conv` and `int8_matmul` are XLA operations in the JAX package, not
Pallas kernels, so the port runs them as library calls.  CPU tensors take
the plain versions: `torch._int_mm` for the matmul, and for the conv a
float64 `F.conv{1,2,3}d` over the int8 values, cast to int32, which is exact
(|acc| <= 127^2 * K < 2^53).  CUDA tensors take the card route: im2col by
`Tensor.unfold` on the zero-padded int8 input (channels last, so each
window row reads whole channel runs) into one int8 matrix, then
`torch._int_mm` (cuBLASLt's int8 GEMM).  cuBLASLt wants M > 16 and K and N
multiples of 8, so `_int_mm_padded` pads with zeros, which is exact in
integers, and slices the output: R(2+1)D-18 has N = 45, 230, 460, 921 and
K = 147, 690, 1380, 2763.  A CUDA tensor never reaches the plain version.
The scales stay on the device: no host sync per layer.

The counters `int8_conv.calls` and `int8_matmul.calls`
(`utils/profiling.py`) count the products on either device (the coverage
tests and `chip_smoke.py` phase 3q read them).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as td
import torch.nn.functional as F

from peppa_tpu_torch.utils.profiling import count

Q_MAX = 127.0


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as a true division on every device.  CUDA
    computes a division by a Python scalar as a product with its
    reciprocal, which is one ulp off at times; the JAX package divides."""
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, Q_MAX)


def _amax(x: torch.Tensor, group, **kw) -> torch.Tensor:
    """max|x| (over `kw`'s dims), and with `group` the MAX of it over the
    ranks of that process group (the whole tensor's, of which each rank
    holds a slice)."""
    amax = torch.amax(torch.abs(x.float()), **kw)
    if group is not None:
        td.all_reduce(amax, op=td.ReduceOp.MAX, group=group)
    return amax


def absmax_weight_scale(w: torch.Tensor, group=None) -> torch.Tensor:
    """Per-output-channel scale (the channel on axis 0): max|w| over the
    other axes / 127, with those axes kept at size 1 (`group`: `_amax`)."""
    return _scale_of(_amax(w, group, dim=tuple(range(1, w.ndim)),
                           keepdim=True))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8)


def act_scale(x: torch.Tensor, group=None) -> torch.Tensor:
    """Dynamic per-tensor activation scale (a 0-d float32 tensor;
    `group`: `_amax`)."""
    return _scale_of(_amax(x, group))


def dequantize(acc: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """(acc as float32 * scale) in `out_dtype`; `scale` is s_x * w_scale,
    shaped to broadcast over `acc`'s output-channel axis."""
    return (acc.float() * scale).to(out_dtype)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 route for device {x.device}")
    return x.device.type


def _int_mm_padded(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32 by `torch._int_mm`,
    zero-padded to M > 16 and K, N multiples of 8 (cuBLASLt's rules) and
    sliced back; the second operand goes in column-major."""
    m, k = a.shape
    n = b_nk.shape[0]
    mp, kp, np_ = max(m, 17), _ceil8(k), _ceil8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_nk = F.pad(b_nk, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b_nk.contiguous().t())
    return out[:m, :n]


def matmul_acc_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 accumulator of (..., K) int8 by (N, K) int8 (CPU)."""
    k = xq.shape[-1]
    acc = torch._int_mm(xq.reshape(-1, k), wq.t())
    return acc.view(*xq.shape[:-1], wq.shape[0])


def matmul_acc_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The card route of `matmul_acc_plain` (runs on CPU tensors too)."""
    k = xq.shape[-1]
    acc = _int_mm_padded(xq.reshape(-1, k), wq)
    return acc.view(*xq.shape[:-1], wq.shape[0])


def conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor,
                   stride: Sequence[int],
                   padding: Sequence[int]) -> torch.Tensor:
    """int32 accumulator of the N-d conv of channels-first int8 `xq` by
    (O, C, *kernel) int8 `wq`: a float64 conv, exact at these magnitudes
    (CPU)."""
    conv = (F.conv1d, F.conv2d, F.conv3d)[wq.ndim - 3]
    return conv(xq.double(), wq.double(), None, tuple(stride),
                tuple(padding)).to(torch.int32)


def _im2col(xq: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
            padding: Sequence[int]):
    """(cols, out): the windows of the zero-padded channels-last int8 input
    as one (M, K) matrix, K ordered (*kernel, C) and zero-padded to a
    multiple of 8; `out` is the output's spatial shape."""
    nd = len(kernel)
    b, c = xq.shape[:2]
    x = xq.movedim(1, -1)  # (B, *spatial, C)
    pads = [p for q in reversed(tuple(padding)) for p in (q, q)]
    if any(pads):
        x = F.pad(x, [0, 0] + pads)
    for d in range(nd):  # -> (B, *out, C, *kernel)
        x = x.unfold(1 + d, kernel[d], stride[d])
    out = tuple(x.shape[1:1 + nd])
    m, k = b * math.prod(out), c * math.prod(kernel)
    kp = _ceil8(k)
    cols = torch.empty(m, kp, dtype=torch.int8, device=xq.device)
    if kp > k:
        cols[:, k:].zero_()
    order = (0, *range(1, 1 + nd), *range(2 + nd, 2 + 2 * nd), 1 + nd)
    cols.view(b, *out, kp)[..., :k].view(b, *out, *kernel, c).copy_(
        x.permute(order))
    return cols, out


def conv_acc_mm(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
                padding: Sequence[int]) -> torch.Tensor:
    """The card route of `conv_acc_plain` (runs on CPU tensors too):
    `_im2col`, then `_int_mm_padded` with the weights in the same K order.
    Returns (B, O, *out) with channels-last strides."""
    nd = wq.ndim - 2
    n = wq.shape[0]
    cols, out = _im2col(xq, tuple(wq.shape[2:]), stride, padding)
    w2 = wq.permute(0, *range(2, 2 + nd), 1).reshape(n, -1)
    w2 = F.pad(w2, (0, cols.shape[1] - w2.shape[1]))
    acc = _int_mm_padded(cols, w2)  # (M, N)
    return acc.view(xq.shape[0], *out, n).movedim(-1, 1)


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              padding: Sequence[int],
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Quantized drop-in for `F.conv{1,2,3}d(x, w, None, stride, padding)`
    on channels-first `x` and float (O, C, *kernel) `w`; symmetric
    `padding` per spatial axis."""
    count("int8_conv.calls")
    w_scale = absmax_weight_scale(w)
    wq = quantize_int8(w, w_scale)
    s_x = act_scale(x)
    xq = quantize_int8(x, s_x)
    if _device_of(x) == "cpu":
        acc = conv_acc_plain(xq, wq, stride, padding)
    else:
        acc = conv_acc_mm(xq, wq, stride, padding)
    scale = (s_x * w_scale.reshape(-1)).view(-1, *([1] * (w.ndim - 2)))
    return dequantize(acc, scale, out_dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16,
                group=None) -> torch.Tensor:
    """Quantized x @ w^T for (..., K) `x` and float (N, K) `w` with
    per-N weight scales.  `group` (a row-parallel layer,
    `models/layers.py::Dense`): `x` and `w` hold this rank's slice of K;
    the scales are the whole tensors' (the MAX over the group) and the
    int32 accumulators are summed over the group before the dequantize,
    so every rank gets the unsplit product bit for bit."""
    count("int8_matmul.calls")
    w_scale = absmax_weight_scale(w, group)
    wq = quantize_int8(w, w_scale)
    s_x = act_scale(x, group)
    xq = quantize_int8(x, s_x)
    if _device_of(x) == "cpu":
        acc = matmul_acc_plain(xq, wq)
    else:
        acc = matmul_acc_mm(xq, wq)
    if group is not None:
        acc = acc.contiguous()
        td.all_reduce(acc, op=td.ReduceOp.SUM, group=group)
    return dequantize(acc, s_x * w_scale.reshape(-1), out_dtype)
