"""Fused triplet loss and its closed-form gradient: the CUDA kernel and its
plain version.

Replaces the TPU kernel peppa_tpu/ops/pallas/loss.py (`_loss_kernel` via
`_fused_loss_fwd_call`, public `fused_triplet_loss`) and its `custom_vjp`
backward `_bwd`.  The kernel is `peppa_tpu_torch/csrc/loss.cu`; its source
note gives its bound on an H100 and its design (one launch of one
thread-block cluster up to B = 64, with the gradient in the same launch;
a row pass, a tile pass and a gradient pass beyond).

On CPU tensors `fused_triplet_loss` runs the plain version and, under
autograd, the plain closed-form backward `triplet_loss_bwd`.  On CUDA
tensors it launches the kernel or raises: without autograd for the loss
alone; under autograd for the loss and its gradient (for an output gradient
of 1) in the same launch, which the backward only scales by the output
gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch


def _norm_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(n, min=1e-12)


def fused_triplet_loss_plain(v: torch.Tensor, a: torch.Tensor,
                             margin: float = 0.2) -> torch.Tensor:
    """contrastive(cosine_matrix(v, a), margin) in float32, as the kernel
    computes it: both hinges, diagonal excluded, summed and divided by B^2."""
    vn = _norm_rows(v.float())
    an = _norm_rows(a.float())
    m = vn @ an.T
    b = m.shape[0]
    diag = torch.diagonal(m)
    c = (torch.clamp(margin + m - diag[None, :], min=0.0)
         + torch.clamp(margin + m - diag[:, None], min=0.0))
    eye = torch.eye(b, dtype=torch.bool, device=m.device)
    return torch.sum(c.masked_fill(eye, 0.0)) / (b * b)


def triplet_loss_bwd(v: torch.Tensor, a: torch.Tensor, g, margin: float = 0.2
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dv, da) of the fused loss for the output gradient `g`, in closed
    form.  With N_v, N_a the row-normalised embeddings and M = N_v N_a^T:

      dL/dM[i,j] (i != j) = (1[col hinge ij > 0] + 1[row hinge ij > 0]) / B^2
      dL/dM[j,j] -= sum_i 1[col hinge ij > 0] / B^2
      dL/dM[i,i] -= sum_j 1[row hinge ij > 0] / B^2

    then back through the product and the L2 normalisation."""
    v32, a32 = v.float(), a.float()
    nv = torch.clamp(torch.linalg.norm(v32, dim=1, keepdim=True), min=1e-12)
    na = torch.clamp(torch.linalg.norm(a32, dim=1, keepdim=True), min=1e-12)
    vn, an = v32 / nv, a32 / na
    m = vn @ an.T
    b = m.shape[0]
    diag = torch.diagonal(m)
    off = ~torch.eye(b, dtype=torch.bool, device=m.device)
    col = ((margin + m - diag[None, :]) > 0) & off
    row = ((margin + m - diag[:, None]) > 0) & off
    g_m = col.float() + row.float()
    g_m = g_m - torch.diag(col.sum(dim=0).float())
    g_m = g_m - torch.diag(row.sum(dim=1).float())
    g_m = g_m * (g / (b * b))
    d_vn = g_m @ an
    d_an = g_m.T @ vn
    d_v = (d_vn - vn * torch.sum(d_vn * vn, dim=1, keepdim=True)) / nv
    d_a = (d_an - an * torch.sum(d_an * an, dim=1, keepdim=True)) / na
    return d_v.to(v.dtype), d_a.to(a.dtype)


def fused_triplet_loss_and_grad_plain(
        v: torch.Tensor, a: torch.Tensor, margin: float = 0.2
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, dL/dV, dL/dA) for an output gradient of 1: the plain version
    of the kernel's launch with the gradient."""
    d_v, d_a = triplet_loss_bwd(v, a, 1.0, margin)
    return fused_triplet_loss_plain(v, a, margin), d_v, d_a


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point and its workspace query, built and loaded at first
    use."""
    from peppa_tpu_torch.ops.cuda.build import library

    lib = library("loss")
    fn = lib.peppa_triplet_loss
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    work = lib.peppa_triplet_loss_workspace
    work.argtypes = [ctypes.c_int, ctypes.c_int]
    work.restype = ctypes.c_longlong
    return fn, functools.lru_cache(maxsize=64)(work)


def _launch(v: torch.Tensor, a: torch.Tensor, margin: float, grad: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                       Optional[torch.Tensor]]:
    """The kernel on (B, D) CUDA tensors of the current device: the loss (a
    0-d float32 tensor) and, with `grad`, dL/dV and dL/dA for an output
    gradient of 1 ((B, D) float32), else None for both.  One allocation
    holds the outputs (and, past B = 64, the kernel's scratch)."""
    if v.ndim != 2 or v.shape != a.shape or v.device != a.device:
        raise ValueError("v and a must be (B, D) on one device")
    b, d = v.shape
    if b == 0 or d == 0:
        raise ValueError(f"empty batch or embedding: {tuple(v.shape)}")
    if v.device.index != torch.cuda.current_device():
        raise ValueError(f"the loss kernel runs on the current device, "
                         f"cuda:{torch.cuda.current_device()}; got {v.device}")
    v = v.float().contiguous()
    a = a.float().contiguous()
    fn, work = _kernel()
    n_out = 2 * b * d + 1 if grad else 1  # [dV | dA |] loss
    buf = torch.empty(n_out + work(b, int(grad)), dtype=torch.float32,
                      device=v.device)
    base = buf.data_ptr()
    err = fn(v.data_ptr(), a.data_ptr(), base + 4 * (n_out - 1),
             base if grad else None, base + 4 * b * d if grad else None,
             base + 4 * n_out, b, d, float(margin),
             torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"triplet-loss kernel launch failed: cudaError {err}")
    fused_triplet_loss.launches += 1
    loss = buf[n_out - 1]
    if not grad:
        return loss, None, None
    return loss, buf[:b * d].view(b, d), buf[b * d:2 * b * d].view(b, d)


class _TripletLoss(torch.autograd.Function):
    """The fused loss under autograd.  CUDA: the kernel's one launch gives
    the loss and its gradient for an output gradient of 1; the backward
    scales it.  CPU: the plain forward, then the plain closed form."""

    @staticmethod
    def forward(ctx, v, a, margin):
        ctx.margin = margin
        ctx.dtypes = (v.dtype, a.dtype)
        if v.device.type == "cpu":
            ctx.save_for_backward(v, a)
            return fused_triplet_loss_plain(v, a, margin)
        loss, d_v, d_a = _launch(v, a, margin, grad=True)
        ctx.save_for_backward(d_v, d_a)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if x.device.type == "cpu":  # x, y are v, a
            d_v, d_a = triplet_loss_bwd(x, y, g, ctx.margin)
            return d_v, d_a, None
        # x, y are the kernel's dV, dA for g = 1
        return (g * x).to(ctx.dtypes[0]), (g * y).to(ctx.dtypes[1]), None


def fused_triplet_loss(v: torch.Tensor, a: torch.Tensor,
                       margin: float = 0.2) -> torch.Tensor:
    """contrastive(cosine_matrix(v, a), margin) as one fused computation;
    a float32 scalar, differentiable in v and a.  CPU tensors: the plain
    version; CUDA: the kernel."""
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no triplet-loss kernel for device {v.device}")
    if torch.is_grad_enabled() and (v.requires_grad or a.requires_grad):
        return _TripletLoss.apply(v, a, margin)
    if v.device.type == "cpu":
        return fused_triplet_loss_plain(v, a, margin)
    return _launch(v, a, margin, grad=False)[0]


# calls that launched the kernel: one launch up to B = 64, two or three
# beyond (CPU calls do not count)
fused_triplet_loss.launches = 0
