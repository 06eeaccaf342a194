"""The device mesh over `torch.distributed`: its 'data' axis and the
collectives of data-parallel training, its 'model' axis and the
tensor-parallel rules of the wav2vec2 transformer.

Mirrors peppa_tpu/parallel/mesh.py.  The port runs one process per card
(`utils/dist.py`), so the mesh's devices are the ranks of the process
group: rank r of W = data x model ranks sits at data index r // model and
model index r % model (the JAX package's row-major reshape of the device
list).  The ranks of one data index (a "data row") hold the same rows and
split the transformer's heads and FFN columns between them; the ranks of
one model index split the global batch.  A run of W processes with a
micro-batch of B rows a data row trains on global batches of data * B
rows and computes what the JAX package computes under a ('data', 'model')
mesh.  Where XLA inserts the collectives of a sharded jit, the port calls
them.  Over the data group (`Mesh.group`):

- `all_gather_rows`: the embeddings of every data row (the global-negative
  loss, `parallel/contrastive.py`; mesh serving, `serving.py`);
- `global_moments`: BatchNorm's batch statistics over the global batch
  (`sync_batch_norm` points every BatchNorm of a model at it);
- `all_reduce_grads`: the gradient of the global loss with respect to the
  replicated parameters, the SUM over the data rows of each one's backward,
  in flat buckets (`training/state.py`, once per optimizer step).

Over the model group (`Mesh.model_group`), the Megatron pairing of
`_TP_RULES` (`shard_model`): q/k/v and `ffn_in` split their outputs
(column-parallel), `out_proj` and `ffn_out` their inputs (row-parallel), so
that each layer needs two all-reduces forward and two backward:

- `copy_to_model`: a column-parallel layer's input, the identity, whose
  backward sums the ranks' input gradients;
- `reduce_over_model`: a row-parallel layer's partial products, summed,
  whose backward passes the gradient on (`models/layers.py::Dense`);
- `gather_model` / `slice_model`: whole tensors from the shards and back
  (checkpoints, `training/state.py`);
- `broadcast_over_model`: model rank 0's gradients of the parameters the
  data row holds whole, once per optimizer step (`training/state.py`).

Over every rank: `agree`, one decision from host flags that may differ
between ranks (each rank's clock, a signal), so that no rank leaves a loop
while another waits in a collective; `replicate_tree`, rank 0's tensors on
every rank.

Autograd through the data collectives follows one rule: each rank's
backward carries the terms of the loss that rank computed.  So a sum that
feeds every rank's terms (the gathered rows, the BatchNorm sums)
all-reduces its incoming gradient; the loss, a sum of per-rank terms,
passes it on as it is; and a value every rank computes alike from gathered
rows (`replicated`) hands each rank 1/W of its gradient.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as td

# the gradient all-reduce's flat buckets (float32: 16M values each)
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape` over `axes`.  `rank` is this process's place on 'data' and
    `group` the data group (the ranks of its model index), which carry
    the collectives of the data axis; `model_rank` and `model_group` (the
    ranks of its data row, None while 'model' has one rank) those of the
    model axis; `host_group` (gloo, every rank) those of host flags.  The
    groups are None without a process group."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int = 0
    group: Optional[Any] = None
    host_group: Optional[Any] = None
    model_rank: int = 0
    model_group: Optional[Any] = None

    @property
    def data(self) -> int:
        """The number of ranks on 'data': the global batch's slabs."""
        return dict(zip(self.axes, self.shape)).get("data", 1)

    @property
    def model(self) -> int:
        """The number of ranks on 'model': the shards of each split
        tensor."""
        return dict(zip(self.axes, self.shape)).get("model", 1)

    @property
    def data_group(self) -> Optional[Any]:
        return self.group

    def global_rank(self, model_rank: int) -> int:
        """The process-group rank of `model_rank` in this rank's data
        row."""
        return self.rank * self.model + model_rank


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The mesh of `tpu.mesh_shape` over `tpu.mesh_axes`, checked against
    the process group (one rank without one): data x model ranks.
    `mesh_shape=None` puts every rank on 'data'.  Every rank of the group
    calls it alike: it creates every model and data group, in one order."""
    world = td.get_world_size() if td.is_initialized() else 1
    axes = tuple(axes)
    shape = ((world,) + (1,) * (len(axes) - 1) if mesh_shape is None
             else tuple(int(n) for n in mesh_shape))
    if len(shape) != len(axes) or "data" not in axes:
        raise ValueError(f"mesh_shape {shape} over axes {axes}: one size "
                         "per axis, and a 'data' axis")
    for axis, n in zip(axes, shape):
        if axis not in ("data", "model") and n > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n}: the port shards the batch "
                "over 'data' and the transformer over 'model' only")
    sizes = dict(zip(axes, shape))
    data, model = sizes["data"], sizes.get("model", 1)
    if data * model != world:
        raise ValueError(f"mesh_shape {shape} puts {data * model} ranks on "
                         f"the mesh; the process group has {world}")
    if not td.is_initialized():
        return Mesh(shape, axes)
    rank = td.get_rank()
    host = td.group.WORLD
    if world > 1 and td.get_backend() != "gloo":
        host = td.new_group(backend="gloo")
    data_group, model_group = td.group.WORLD, None
    if model > 1:
        model_groups = [td.new_group(list(range(d * model, (d + 1) * model)))
                        for d in range(data)]
        data_groups = [td.new_group(list(range(m, world, model)))
                       for m in range(model)]
        data_group = data_groups[rank % model]
        model_group = model_groups[rank // model]
    return Mesh(shape, axes, rank=rank // model, group=data_group,
                host_group=host, model_rank=rank % model,
                model_group=model_group)


def data_axis_of(config) -> Tuple[int, int]:
    """(this process's data index, the data ranks) of the mesh that
    `config.tpu.mesh_shape` lays over the process group, from the rank and
    the group's size alone: the batch slab a data module yields."""
    from peppa_tpu_torch.utils import dist

    model = 1
    if config.tpu.mesh_shape is not None:
        model = int(dict(zip(config.tpu.mesh_axes,
                             config.tpu.mesh_shape)).get("model", 1))
    return dist.process_index() // model, dist.process_count() // model


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
    rank) with its SUM over the data group, in place, in flat buckets of
    about `bucket_bytes`."""
    _bucketed(tensors, bucket_bytes, lambda flat: td.all_reduce(
        flat, op=td.ReduceOp.SUM, group=mesh.group))


def broadcast_over_model(tensors: Sequence[torch.Tensor], mesh: Mesh,
                         bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor (the same list on every rank) with model rank
    0's, in place, over the model group, in flat buckets: the gradients of
    the parameters every rank of a data row holds whole, so that the row
    takes one step whatever order the card's kernels add in (cuDNN's
    weight gradients add with atomics, so two ranks' backward passes of
    the same rows differ in the last bits)."""
    _bucketed(tensors, bucket_bytes, lambda flat: td.broadcast(
        flat, src=mesh.global_rank(0), group=mesh.model_group))


def _bucketed(tensors: Sequence[torch.Tensor], bucket_bytes: int,
              collective) -> None:
    bucket, size = [], 0
    for t in tensors:
        bucket.append(t)
        size += t.numel() * t.element_size()
        if size >= bucket_bytes:
            _flat_collective(bucket, collective)
            bucket, size = [], 0
    if bucket:
        _flat_collective(bucket, collective)


def _flat_collective(tensors: Sequence[torch.Tensor], collective) -> None:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


def agree(mesh: Mesh, *flags: bool) -> Tuple[bool, ...]:
    """Each flag true on any rank, the same answer on every rank: one
    all-reduce (MAX) of a few host integers over `host_group`."""
    if mesh.data * mesh.model == 1:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    td.all_reduce(t, op=td.ReduceOp.MAX, group=mesh.host_group)
    return tuple(bool(v) for v in t.tolist())


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """`tree` (nested dicts, lists and tuples of tensors) with every
    tensor replaced, in place, by rank 0's: one broadcast each over every
    rank of the mesh, as the JAX function replicates over the whole mesh.
    Every rank calls it with tensors of the same shapes."""
    if mesh.data * mesh.model > 1:
        for t in _tensors(tree):
            td.broadcast(t, src=0)
    return tree


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


# ------------------------------------------------------------ the model axis
class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the gradient over the model
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        td.all_reduce(g, op=td.ReduceOp.SUM, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel layer, which every rank of the data
    row holds whole: the identity forward; backward, the SUM of the ranks'
    gradients, each from its own output columns."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The SUM over the model group of a row-parallel layer's partial
    products; the backward hands each rank the whole gradient."""
    return _AllReduceSum.apply(x, mesh.model_group, False)


def gather_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which `x` is this rank's slice along `dim`:
    one broadcast per model rank over the model group (bit for bit;
    gloo carries no all-gather of CUDA tensors)."""
    x = x.detach().contiguous()
    parts = []
    for m in range(mesh.model):
        part = x if m == mesh.model_rank else torch.empty_like(x)
        td.broadcast(part, src=mesh.global_rank(m), group=mesh.model_group)
        parts.append(part)
    return torch.cat(parts, dim)


def slice_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice along `dim` of a whole tensor (a copy)."""
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * n, n).clone()


# (name regex, split dimension): the JAX package's `_TP_RULES` on the
# port's parameter names, first match wins.  The port's Dense weight is
# (out, in), so the JAX P(None, "model") of a kernel (in, out) splits dim 0
# and P("model", None) dim 1: q/k/v and FFN-in on their outputs
# (column-parallel, with their biases), out-proj and FFN-out on their
# inputs (row-parallel, whose biases every rank holds whole and adds once,
# after the sum).
_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*wav2vec2\.layer\d+\.attention\.(q|k|v)_proj\.weight", 0),
    (r".*wav2vec2\.layer\d+\.attention\.(q|k|v)_proj\.bias", 0),
    (r".*wav2vec2\.layer\d+\.attention\.out_proj\.weight", 1),
    (r".*wav2vec2\.layer\d+\.ffn_in\.weight", 0),
    (r".*wav2vec2\.layer\d+\.ffn_in\.bias", 0),
    (r".*wav2vec2\.layer\d+\.ffn_out\.weight", 1),
)


def _spec_for(name: str, ndim: int, use_tp: bool) -> Optional[int]:
    if use_tp:
        for pattern, dim in _TP_RULES:
            if re.fullmatch(pattern, name) and dim < ndim:
                return dim
    return None


def param_shardings(model_or_state_dict: Union[torch.nn.Module,
                                               Dict[str, torch.Tensor]],
                    mesh: Mesh, tensor_parallel: bool = True
                    ) -> Dict[str, Optional[int]]:
    """{name: the dimension split over 'model', or None (replicated)} of a
    model's parameters or of a state dict's tensors (buffers match no
    rule)."""
    use_tp = tensor_parallel and mesh.model > 1
    named = (dict(model_or_state_dict.named_parameters())
             if isinstance(model_or_state_dict, torch.nn.Module)
             else model_or_state_dict)
    return {name: _spec_for(name, t.ndim, use_tp)
            for name, t in named.items()}


def state_shardings(state, mesh: Mesh, tensor_parallel: bool = True
                    ) -> Dict[str, Dict[Any, Optional[int]]]:
    """The split dimensions of a `TrainState`'s tensors: "model" (its
    state dict's names), "optimizer" (BertAdam's per-parameter moments, by
    the index of the trained parameter) and "acc_grads"; the moments and
    the buffer are split as their parameter is."""
    params = param_shardings(state.model, mesh, tensor_parallel)
    return {"model": param_shardings(state.model.state_dict(), mesh,
                                     tensor_parallel),
            "optimizer": {i: params[name]
                          for i, name in enumerate(state.params)},
            "acc_grads": {name: params[name] for name in state.params}}


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's slices of the tensors `param_shardings` splits
    (in place) and point the transformer layers at the model axis: each
    attention runs this rank's num_heads / model heads and each FFN its
    ffn_dim / model columns (`models/wav2vec2.py`).  Raises where 'model'
    does not divide a layer's heads or FFN width.  Returns `model`, with
    `model.mesh` set; a mesh with one model rank leaves it whole."""
    from peppa_tpu_torch.models.wav2vec2 import TransformerLayer

    if mesh.model == 1:
        return model
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is sharded already")
    split = param_shardings(model, mesh)
    layers = {name: m for name, m in model.named_modules()
              if isinstance(m, TransformerLayer)}
    for name, layer in layers.items():
        heads, ffn = layer.attention.heads, layer.ffn_in.weight.shape[0]
        if heads % mesh.model or ffn % mesh.model:
            raise ValueError(
                f"a model axis of {mesh.model} ranks does not divide "
                f"{heads} attention heads and {ffn} FFN columns")
        if split.get(f"{name}.ffn_in.weight") is None:
            raise ValueError(f"{name}: no tensor-parallel rule matches its "
                             "parameters (a layer of a 'wav2vec2' module)")
    with torch.no_grad():
        for name, dim in split.items():
            if dim is not None:
                p = model.get_parameter(name)
                p.data = slice_model(p.data, dim, mesh)
    for layer in layers.values():
        layer.shard(mesh)
    model.mesh = mesh
    return model
