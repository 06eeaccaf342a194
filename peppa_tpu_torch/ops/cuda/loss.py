"""Fused triplet loss and its closed-form gradient: the CUDA kernel and its
plain version.

Replaces the TPU kernel peppa_tpu/ops/pallas/loss.py (`_loss_kernel` via
`_fused_loss_fwd_call`, public `fused_triplet_loss`) and its `custom_vjp`
backward `_bwd`.  The kernel is `peppa_tpu_torch/csrc/loss.cu`; its source
note gives its bound on an H100 and its design (one launch of one
thread-block cluster up to B = 64, with the gradient in the same launch;
a row pass, a tile pass and a gradient pass beyond).

Under autograd `fused_triplet_loss` calls the dispatcher op
`torch.ops.peppa_tpu_torch.fused_triplet_loss` (v, a, margin) -> (loss,
dL/dV, dL/dA), the gradients float32 for an output gradient of 1: on CPU
tensors the plain version (`fused_triplet_loss_and_grad_plain`), on CUDA
tensors one launch of the kernel with its gradient; its fake gives the
shapes, and its autograd (`torch.library.register_autograd`) only scales
the saved gradients by the output gradient and casts them to v's and a's
dtypes.  Without autograd it runs the plain loss on the CPU and the kernel
without its gradient on the card.  On CUDA tensors it launches the kernel
or raises.  The counter `fused_triplet_loss.launches` (`utils/profiling.py`)
counts the calls that launched it: one launch up to B = 64, two or three
beyond (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from peppa_tpu_torch.utils.profiling import count


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


def triplet_loss_bwd(v: torch.Tensor, a: torch.Tensor, margin: float = 0.2
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dv, da) of the fused loss for an output gradient of 1, in closed
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
    g_m = g_m * (1.0 / (b * b))
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
    d_v, d_a = triplet_loss_bwd(v, a, margin)
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
    gradient of 1 ((B, D) float32, each its own tensor), else None for
    both.  The loss and, past B = 64, the kernel's scratch share one
    allocation."""
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
    buf = torch.empty(1 + work(b, int(grad)), dtype=torch.float32,
                      device=v.device)  # loss | scratch
    d_v = d_a = None
    if grad:
        d_v, d_a = (torch.empty((b, d), dtype=torch.float32, device=v.device)
                    for _ in range(2))
    base = buf.data_ptr()
    err = fn(v.data_ptr(), a.data_ptr(), base,
             None if d_v is None else d_v.data_ptr(),
             None if d_a is None else d_a.data_ptr(), base + 4, b, d,
             float(margin), torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"triplet-loss kernel launch failed: cudaError {err}")
    count("fused_triplet_loss.launches")
    return buf[0], d_v, d_a


# The loss with its gradient as one dispatcher op (module doc), registered
# through `torch.library.Library` as the attention ops are
# (ops/cuda/attention.py); its CPU kernel computes in float32, as the CUDA
# kernel reads its inputs.
_LIBRARY = torch.library.Library("peppa_tpu_torch", "FRAGMENT")
_LIBRARY.define("fused_triplet_loss(Tensor v, Tensor a, float margin) -> "
                "(Tensor, Tensor, Tensor)")


def _loss_op_cpu(v, a, margin):
    return fused_triplet_loss_and_grad_plain(v.float(), a.float(), margin)


def _loss_op_cuda(v, a, margin):
    return _launch(v, a, margin, grad=True)


def _loss_op_fake(v, a, margin):
    return (v.new_empty((), dtype=torch.float32),
            v.new_empty(v.shape, dtype=torch.float32),
            a.new_empty(a.shape, dtype=torch.float32))


def _loss_setup_context(ctx, inputs, output):
    v, a, _ = inputs
    _, d_v, d_a = output
    ctx.mark_non_differentiable(d_v, d_a)
    ctx.set_materialize_grads(False)  # no zeros for dV's and dA's gradients
    ctx.save_for_backward(d_v, d_a)
    ctx.dtypes = (v.dtype, a.dtype)


def _loss_backward(ctx, g, _g_v, _g_a):
    d_v, d_a = ctx.saved_tensors  # for an output gradient of 1
    return (g * d_v).to(ctx.dtypes[0]), (g * d_a).to(ctx.dtypes[1]), None


_LIBRARY.impl("fused_triplet_loss", _loss_op_cpu, "CPU")
_LIBRARY.impl("fused_triplet_loss", _loss_op_cuda, "CUDA")
torch.library.register_fake("peppa_tpu_torch::fused_triplet_loss",
                            _loss_op_fake, lib=_LIBRARY)
torch.library.register_autograd("peppa_tpu_torch::fused_triplet_loss",
                                _loss_backward,
                                setup_context=_loss_setup_context,
                                lib=_LIBRARY)
loss_op = torch.ops.peppa_tpu_torch.fused_triplet_loss.default


def fused_triplet_loss(v: torch.Tensor, a: torch.Tensor,
                       margin: float = 0.2) -> torch.Tensor:
    """contrastive(cosine_matrix(v, a), margin) as one fused computation;
    a float32 scalar, differentiable in v and a (through `loss_op`).  CPU
    tensors: the plain version; CUDA: the kernel."""
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no triplet-loss kernel for device {v.device}")
    if torch.is_grad_enabled() and (v.requires_grad or a.requires_grad):
        return loss_op(v, a, float(margin))[0]
    if v.device.type == "cpu":
        return fused_triplet_loss_plain(v, a, margin)
    return _launch(v, a, margin, grad=False)[0]
