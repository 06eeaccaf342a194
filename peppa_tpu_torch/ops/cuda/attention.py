"""Multi-head attention forward: the CUDA kernel and its plain version.

Replaces the TPU kernel peppa_tpu/ops/pallas/attention.py (`_fwd_kernel`
via `_attend_fwd`, public `mha_attention`).  The kernel is
`peppa_tpu_torch/csrc/attention.cu`; its source note gives its bound on an
H100 and its design (flash-style, online softmax in float32, any T; bf16 on
the tensor cores, float32 on the CUDA cores).

`mha_attention` takes (B, T, H, hd) q/k/v in float32 or bfloat16 and returns
the same layout in q's dtype.  On CPU tensors it runs the plain version; on
CUDA tensors it launches the kernel or raises.  Gradients come with the
training slice: a CUDA tensor that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -1e30  # masked-key score, as the TPU kernel's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale * q k^T, keys >= lengths[b] at -1e30) v in float32."""
    b, t, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if lengths is not None:
        mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    from peppa_tpu_torch.ops.cuda.build import library

    fn = library("attention").peppa_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths, scale) -> torch.Tensor:
    b, t, h, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention kernel takes float32/bfloat16, got {q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"attention kernel head_dim must be in {_HEAD_DIMS}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "the attention backward kernel comes with the training slice")
    lens_ptr = None
    if lengths is not None:
        if lengths.shape != (b,):
            raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        lens_ptr = lengths.data_ptr()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lens_ptr, _DTYPES[q.dtype], b, t, h,
                        hd, strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    mha_attention.launches += 1
    return out


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, (B, T, H, hd) in and out (q's dtype).

    `lengths` (B,) marks the valid keys of each example (>= 1; None: all
    T).  CPU tensors: the plain version; CUDA tensors: the kernel.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v, lengths, scale)


mha_attention.launches = 0  # kernel launches (CPU calls do not count)
