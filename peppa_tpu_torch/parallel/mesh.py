"""The data axis of the device mesh, over `torch.distributed`, and the
collectives of data-parallel training.

Mirrors the data half of peppa_tpu/parallel/mesh.py.  The port runs one
process per card (`utils/dist.py`), so the mesh's devices are the ranks of
the process group: a run of W processes, each with a micro-batch of B
rows, trains on global batches of W * B rows and computes what the JAX
package computes on them under a ('data',) mesh.  Where XLA inserts the
collectives of a sharded jit, the port calls them:

- `all_gather_rows`: the embeddings of every rank (the global-negative
  loss, `parallel/contrastive.py`);
- `global_moments`: BatchNorm's batch statistics over the global batch
  (`sync_batch_norm` points every BatchNorm of a model at it);
- `all_reduce_grads`: the gradient of the global loss with respect to the
  replicated parameters, the SUM over the ranks of each rank's backward, in
  flat buckets (`training/state.py`, once per optimizer step);
- `agree`: one decision from host flags that may differ between ranks
  (each rank's clock, a signal), so that no rank leaves a loop while
  another waits in a collective.

Autograd through them follows one rule: each rank's backward carries the
terms of the loss that rank computed.  So a sum that feeds every rank's
terms (the gathered rows, the BatchNorm sums) all-reduces its incoming
gradient; the loss, a sum of per-rank terms, passes it on as it is; and a
value every rank computes alike from gathered rows (`replicated`) hands
each rank 1/W of its gradient.

The JAX module's tensor-parallel rules (`_TP_RULES`, `param_shardings`)
and mesh serving are not ported (ROADMAP A.5.8b): a 'model' axis above 1
raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as td

# the gradient all-reduce's flat buckets (float32: 16M values each)
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape` over `axes`; `rank` is this process's place on 'data'.
    `group` carries the collectives of device tensors, `host_group` (gloo)
    those of host flags; both are None without a process group."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int = 0
    group: Optional[Any] = None
    host_group: Optional[Any] = None

    @property
    def data(self) -> int:
        """The number of ranks on 'data': the global batch's slabs."""
        return dict(zip(self.axes, self.shape)).get("data", 1)


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The mesh of `tpu.mesh_shape` over `tpu.mesh_axes`, checked against
    the process group (one rank without one).  `mesh_shape=None` puts
    every rank on 'data'.  Every rank of the group calls it alike."""
    world = td.get_world_size() if td.is_initialized() else 1
    axes = tuple(axes)
    shape = ((world,) + (1,) * (len(axes) - 1) if mesh_shape is None
             else tuple(int(n) for n in mesh_shape))
    if len(shape) != len(axes) or "data" not in axes:
        raise ValueError(f"mesh_shape {shape} over axes {axes}: one size "
                         "per axis, and a 'data' axis")
    for axis, n in zip(axes, shape):
        if axis != "data" and n > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n}: the port shards the batch "
                "over 'data' only (tensor parallelism and mesh serving are "
                "ROADMAP A.5.8b)")
    data = dict(zip(axes, shape))["data"]
    if data != world:
        raise ValueError(f"mesh_shape {shape} puts {data} ranks on 'data'; "
                         f"the process group has {world}")
    if not td.is_initialized():
        return Mesh(shape, axes)
    host = td.group.WORLD
    if world > 1 and td.get_backend() != "gloo":
        host = td.new_group(backend="gloo")
    return Mesh(shape, axes, rank=td.get_rank(), group=td.group.WORLD,
                host_group=host)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slab of a global batch that every rank holds (a
    `ClipBatch` or a tensor): rows [rank * B, (rank + 1) * B) with B =
    global rows / W.  In training each rank's data module yields its slab
    already (`data/datamodule.py::multihost_interleave`), and validation
    needs no counterpart of the JAX `replicate_batch`: every rank's
    loaders yield the whole batch."""
    if dataclasses.is_dataclass(batch):
        return type(batch)(**{f.name: shard_batch(getattr(batch, f.name),
                                                  mesh)
                              for f in dataclasses.fields(batch)})
    if batch is None:
        return None
    n = batch.shape[0]
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over {mesh.data} ranks")
    b = n // mesh.data
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


class _AllReduceSum(torch.autograd.Function):
    """The SUM over the ranks; the backward all-reduces the incoming
    gradient (`reduce_grad`) or passes it on."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        y = x.contiguous().clone()
        td.all_reduce(y, op=td.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        if not ctx.reduce_grad:
            return grad, None, None
        g = grad.contiguous().clone()
        td.all_reduce(g, op=td.ReduceOp.SUM, group=ctx.group)
        return g, None, None


class _Replicated(torch.autograd.Function):
    """The identity; the backward scales the gradient by 1 / W."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                   reduce_grad: bool = True) -> torch.Tensor:
    """Σ over the ranks of `x`, with autograd: `reduce_grad` for a sum that
    feeds every rank's terms (module doc), else the gradient passes as it
    is (a loss summed from per-rank terms)."""
    return _AllReduceSum.apply(x, mesh.group, reduce_grad)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(W * B, ...) rows of every rank, rank r's at [r * B, (r + 1) * B),
    with autograd: the backward all-reduces the incoming gradient and keeps
    this rank's slot.  The forward all-reduces a zero-filled buffer with
    this rank's slot written (exact: each value is added to zeros), since
    gloo carries only broadcast and all-reduce for CUDA tensors."""
    b = x.shape[0]
    pad = [0, 0] * (x.ndim - 1) + [mesh.rank * b,
                                   (mesh.data - 1 - mesh.rank) * b]
    return all_reduce_sum(torch.nn.functional.pad(x, pad), mesh)


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x`, a value every rank computes alike (from gathered rows), with
    1 / W of its gradient on each rank, so that the gradient all-reduce
    sums to the whole."""
    return _Replicated.apply(x, mesh.data)


def global_moments(x: torch.Tensor, dims: Tuple[int, ...],
                   mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) over `dims` of the global batch, per channel (dim 1),
    from one all-reduce of Σx and Σx^2, with autograd.  The count is the
    host's: every rank holds a slab of the same shape
    (`data/datamodule.py::multihost_interleave`)."""
    c = x.shape[1]
    count = x.numel() // c * mesh.data
    sums = all_reduce_sum(torch.cat([torch.sum(x, dim=dims),
                                     torch.sum(x * x, dim=dims)]), mesh)
    return sums[:c] / count, sums[c:] / count


def sync_batch_norm(model: torch.nn.Module, mesh: Mesh) -> None:
    """Point every BatchNorm of `model` at the global batch of `mesh` (its
    own batch again when the mesh has one rank on 'data')."""
    from peppa_tpu_torch.models.layers import BatchNorm

    moments = (functools.partial(global_moments, mesh=mesh)
               if mesh.data > 1 else None)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.moments = moments


def all_reduce_grads(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor (float32 gradients, the same list on every
    rank) with its SUM over the ranks, in place, in flat buckets of about
    `bucket_bytes`."""
    bucket, size = [], 0
    for t in tensors:
        bucket.append(t)
        size += t.numel() * t.element_size()
        if size >= bucket_bytes:
            _reduce_flat(bucket, mesh)
            bucket, size = [], 0
    if bucket:
        _reduce_flat(bucket, mesh)


def _reduce_flat(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    td.all_reduce(flat, op=td.ReduceOp.SUM, group=mesh.group)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


def agree(mesh: Mesh, *flags: bool) -> Tuple[bool, ...]:
    """Each flag true on any rank, the same answer on every rank: one
    all-reduce (MAX) of a few host integers over `host_group`."""
    if mesh.data == 1:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    td.all_reduce(t, op=td.ReduceOp.MAX, group=mesh.host_group)
    return tuple(bool(v) for v in t.tolist())
