"""Multi-head attention, forward and backward: CUDA kernels and their plain
versions.

Replaces the TPU kernels of peppa_tpu/ops/pallas/attention.py: `_fwd_kernel`
via `_attend_fwd` and `_bwd_kernel` via `_attend_bwd`, wrapped there in a
`jax.custom_vjp` (public `mha_attention`).  The kernels are in
`peppa_tpu_torch/csrc/attention.cu`; its source note gives their bounds on
an H100 and their design.  The bf16 forward's bound is bytes at short T
and tensor work at long T; what holds it back on the card is its
instruction stream (`mma.sync` and the float32 softmax in turn).  It runs
a head-major grid of 128-row query tiles, so the blocks of one (batch,
head) share its K/V through L2, streams K/V through two shared-memory
stages with `cp.async` while `mma.sync` works on the previous tile, and
keeps its online softmax in float32 (log2 units).  The bf16 backward is
built the same way, in two grids without atomics (query tiles for dQ, key
tiles for dK and dV): it recomputes P in the forward's log2 units from the
forward's log-sum-exp and takes D = rowsum(dO o O) from the forward's
output.

float32 runs on the CUDA cores in full float32 FMAs (the port's precision
reference: the aligner's CTC log-probs, the float32 Embedder, float32
training with `audio.dropout: 0.0`, the card-vs-CPU checks).  Both
directions are bound by operations at 67 TF/s: the forward 0.1465 ms at
B=32, T=316 and 0.0292 ms at B=1, T=799; the backward 0.0916 ms at B=8,
T=316 and 0.6257 ms at T=826.  Both are register-tiled like a SIMT SGEMM
(64-row tiles of 128 threads, a 4 x 8 part of each 64 x 64 score tile and
4 rows x HD/8 dims of each output a thread, so one 16-byte shared-memory
load feeds about 11 FMAs) and stream their 64-row tiles through two
`cp.async` stages.  Where the forward's grid of 64-row tiles is too small
for the card (the aligner's B=1) it cuts each row's keys into splits that
a second kernel combines by their log-sum-exps in a fixed order
(`_f32_plan`, from the shapes alone; scratch from `torch.empty` per call).
The float32 backward, like the bf16 one, runs a query-tile grid (dQ, and D
= rowsum(dO o O) from the forward's float32 output) and a key-tile grid
(dK, dV), recomputing P from the forward's natural-log lse in its log2
units; its tiles are XOR-swizzled in shared memory instead of padded, so
two blocks fit on an SM.

`mha_attention` takes (B, T, H, hd) q/k/v in float32 or bfloat16 and returns
the same layout in q's dtype.  When autograd needs its gradient it runs as a
`torch.autograd.Function` whose forward also keeps the log-sum-exp and the
output, and whose backward is the backward kernel; otherwise (serving,
`inference_mode`) it is the forward kernel alone.  On CPU tensors both
directions run the plain versions; on CUDA tensors they launch the kernels
or raise.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Tuple

import torch

NEG_INF = -1e30  # masked-key score, as the TPU kernel's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
# the float32 forward: query rows (and keys) per tile, as `kF32Rows` and
# `kBlockK` in csrc/attention.cu; the blocks it aims for, two waves of two
# resident blocks on each of an H100's 132 SMs
_F32_ROWS = 64
_F32_BLOCKS = 4 * 132
# the launch counters are read while worker threads launch (the aligner's
# pool, preprocess/forced_align.py::realign): each increment holds the lock
_count_lock = threading.Lock()


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


def mha_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `mha_attention_plain` for the output gradient `do`,
    by `_bwd_kernel`'s formulas in float32, in q's dtype:

        P = softmax(scale q k^T, keys >= lengths at -1e30)
        dV = P^T dO;  dP = dO V^T;  dS = P o (dP - rowsum(dP o P))
        dQ = dS K scale;  dK = dS^T Q scale

    dS is zero at masked keys (P is exactly 0 there), so masked keys get
    dK = dV = 0.  A row of length 0 scores every key at the constant -1e30:
    P is uniform over T and dS = 0, so dQ = dK = 0 and dV averages dO.
    """
    b, t, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    mask = None
    if lengths is not None:
        mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    if mask is not None:
        ds = ds.masked_fill(~mask[:, None, None, :], 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entry points (forward, backward), built and loaded at first
    use."""
    from peppa_tpu_torch.ops.cuda.build import library

    lib = library("attention")
    fwd = lib.peppa_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.peppa_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(q, k, v) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention kernel takes float32/bfloat16, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"attention kernel head_dim must be in {_HEAD_DIMS}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")


def _lengths_arg(lengths, q):
    """(lengths as contiguous int32 on q's device or None, its pointer)."""
    if lengths is None:
        return None, None
    b = q.shape[0]
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return lengths, lengths.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _f32_plan(batch: int, heads: int, seq: int) -> Tuple[int, int]:
    """(query rows per tile, key splits) of the float32 forward kernel.

    From the shapes alone (no read of the lengths on the card, so no host
    sync).  A block takes one 64-row query tile; where B*H*ceil(T/64) tiles
    fall short of `_F32_BLOCKS` (the aligner's B=1), each row's keys are
    cut into up to ceil(T/64) contiguous ranges of whole 64-key tiles, one
    block each, combined by their log-sum-exps.  The count is rounded so
    that `_f32_key_splits` leaves no range empty at full length."""
    tiles = -(-seq // _F32_ROWS)
    want = min(tiles, max(1, -(-_F32_BLOCKS // (batch * heads * tiles))))
    per = -(-tiles // want)
    return _F32_ROWS, -(-tiles // per)


def _f32_key_splits(seq: int, n_splits: int) -> List[Tuple[int, int]]:
    """The key range [k0, k1) of each split, as `launch_fwd_f32` cuts them
    (before the row's length clips them)."""
    tiles = -(-seq // _F32_ROWS)
    per = -(-tiles // n_splits) * _F32_ROWS
    return [(min(s * per, seq), min((s + 1) * per, seq))
            for s in range(n_splits)]


def _launch(q, k, v, lengths, scale, with_lse: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel: (out, float32 (B, H, T) log-sum-exp or None).

    The log-sum-exp is the backward kernel's input, of the masked scores
    scaled by `scale`: in natural-log units for float32, in log2 units
    (of the scores times scale * log2(e)) for bfloat16."""
    _check(q, k, v)
    b, t, h, hd = q.shape
    lengths, lens_ptr = _lengths_arg(lengths, q)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    n_splits, scratch = 1, None
    if q.dtype == torch.float32:
        n_splits = _f32_plan(b, h, t)[1]
        if n_splits > 1:
            # each split's unnormalised rows, then its (max, sum) pairs;
            # one buffer per call (the aligner's threads launch at once)
            scratch = torch.empty(n_splits * b * h * t * (hd + 2),
                                  dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    with torch.cuda.device(q.device):
        err = _kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(),
                            lse.data_ptr() if with_lse else None, lens_ptr,
                            _DTYPES[q.dtype], b, t, h, hd, strides,
                            float(scale), _stream(q), n_splits,
                            None if scratch is None else scratch.data_ptr())
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    with _count_lock:
        mha_attention.launches += 1
    return out, lse


def _launch_bwd(q, k, v, do, lse, out, lengths, scale
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(q, k, v)
    b, t, h, hd = q.shape
    if do.shape != q.shape or do.device != q.device:
        raise ValueError("do must match q in shape and device")
    if lse is None or lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("the backward kernel needs the forward's float32 "
                         f"(B, H, T) log-sum-exp, got {lse}")
    if (out is None or out.shape != q.shape or out.dtype != q.dtype
            or out.device != q.device):
        raise ValueError("the backward kernel needs the forward's output, "
                         "in q's shape, dtype and device")
    do = do.to(q.dtype)
    lse = lse.contiguous()
    lengths, lens_ptr = _lengths_arg(lengths, q)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 32)(
        *q.stride(), *k.stride(), *v.stride(), *do.stride(), *dq.stride(),
        *dk.stride(), *dv.stride(), *out.stride())
    with torch.cuda.device(q.device):
        err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), out.data_ptr(), lse.data_ptr(),
                            lens_ptr, dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), delta.data_ptr(),
                            _DTYPES[q.dtype], b, t, h, hd, strides,
                            float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(
            f"attention backward kernel launch failed: cudaError {err}")
    with _count_lock:
        mha_attention_bwd.launches += 1
    return dq, dk, dv


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    return q.device.type


def mha_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None,
                      lse: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's dtype.  CPU tensors: the plain version, which
    ignores `lse` and `out`; CUDA tensors: the backward kernel, which needs
    the forward kernel's log-sum-exp `lse` and output `out` of the same q,
    k, v, lengths and scale (`_launch(..., with_lse=True)`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_of(q) == "cpu":
        return mha_attention_bwd_plain(q, k, v, do, lengths, scale)
    return _launch_bwd(q, k, v, do, lse, out, lengths, scale)


mha_attention_bwd.launches = 0  # kernel launches (CPU calls do not count)


class _Attention(torch.autograd.Function):
    """`mha_attention` under autograd: the forward keeps q, k, v, lengths,
    its output and (on the card) the log-sum-exp; the backward is the
    backward kernel (the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        if q.device.type == "cpu":
            out, lse = mha_attention_plain(q, k, v, lengths, scale), None
        else:
            out, lse = _launch(q, k, v, lengths, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lengths, lse, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, lse, out = ctx.saved_tensors
        dq, dk, dv = mha_attention_bwd(q, k, v, do, lengths, ctx.scale, lse,
                                       out)
        return dq, dk, dv, None, None


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, (B, T, H, hd) in and out (q's dtype).

    `lengths` (B,) marks the valid keys of each example (>= 1; None: all
    T).  CPU tensors: the plain versions; CUDA tensors: the kernels.
    Differentiable in q, k and v.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    device = _device_of(q)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Attention.apply(q, k, v, lengths, scale)
    if device == "cpu":
        return mha_attention_plain(q, k, v, lengths, scale)
    return _launch(q, k, v, lengths, scale)[0]


mha_attention.launches = 0  # forward kernel launches (CPU calls do not count)
