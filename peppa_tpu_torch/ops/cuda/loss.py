"""Fused triplet-loss forward: the CUDA kernel and its plain version.

Replaces the TPU kernel peppa_tpu/ops/pallas/loss.py (`_loss_kernel` via
`_fused_loss_fwd_call`, public `fused_triplet_loss`).  The kernel is
`peppa_tpu_torch/csrc/loss.cu`; its source note gives its bound on an H100
and its design (row pass, tiled hinge pass, fixed-order reduction; any B).

On CPU tensors `fused_triplet_loss` runs the plain version; on CUDA tensors
it launches the kernel or raises.  When autograd needs its gradient it runs
as a `torch.autograd.Function` whose backward is the closed form of
peppa_tpu/ops/pallas/loss.py `_bwd` (`triplet_loss_bwd`): plain PyTorch on
either device, as the JAX package runs it as XLA outside any kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    from peppa_tpu_torch.ops.cuda.build import library

    fn = library("loss").peppa_triplet_loss_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(v: torch.Tensor, a: torch.Tensor, margin: float) -> torch.Tensor:
    if v.ndim != 2 or v.shape != a.shape or v.device != a.device:
        raise ValueError("v and a must be (B, D) on one device")
    b, d = v.shape
    v = v.float().contiguous()
    a = a.float().contiguous()
    tiles = -(-b // 32)
    vn = torch.empty_like(v)
    an = torch.empty_like(a)
    diag = torch.empty(b, dtype=torch.float32, device=v.device)
    partial = torch.empty(tiles * tiles, dtype=torch.float32, device=v.device)
    out = torch.empty((), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = _kernel()(v.data_ptr(), a.data_ptr(), vn.data_ptr(),
                        an.data_ptr(), diag.data_ptr(), partial.data_ptr(),
                        out.data_ptr(), b, d, float(margin), stream)
    if err != 0:
        raise RuntimeError(f"triplet-loss kernel launch failed: cudaError {err}")
    fused_triplet_loss.launches += 1
    return out


def triplet_loss_bwd(v: torch.Tensor, a: torch.Tensor, g: torch.Tensor,
                     margin: float = 0.2
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


class _TripletLoss(torch.autograd.Function):
    """The fused loss under autograd: kernel (or plain) forward, closed-form
    backward."""

    @staticmethod
    def forward(ctx, v, a, margin):
        ctx.save_for_backward(v, a)
        ctx.margin = margin
        if v.device.type == "cpu":
            return fused_triplet_loss_plain(v, a, margin)
        return _launch(v, a, margin)

    @staticmethod
    def backward(ctx, g):
        v, a = ctx.saved_tensors
        d_v, d_a = triplet_loss_bwd(v, a, g, ctx.margin)
        return d_v, d_a, None


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
    return _launch(v, a, margin)


fused_triplet_loss.launches = 0  # kernel launches (CPU calls do not count)
