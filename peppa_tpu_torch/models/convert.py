"""Carry the JAX package's variables across into the port's modules, and
back.

`load_jax_variables(model, variables)` takes the JAX package's
`{"params": ..., "batch_stats": ...}` tree as nested dicts of numpy arrays
(`jax.tree.map(np.asarray, variables)` gives it) and copies every leaf into
the matching parameter or buffer of a port module built from the same
config.  Names follow the JAX module tree; layouts move as follows:

- Dense kernel (in, out) -> weight (out, in);
- Conv1d kernel (k, in, out) -> weight (out, in, k);
- Conv3d kernel (t, h, w, in, out) -> weight (out, in, t, h, w);
- LayerNorm / GroupNorm / BatchNorm `scale` -> `weight`, `bias` as is;
- BatchNorm statistics `mean` / `var` -> `running_mean` / `running_var`;
- the positional conv's `pos_conv_v` / `pos_conv_g` / `pos_conv_bias` as is.

Any missing, unused or mis-shaped leaf raises.  `export_jax_variables(model)`
is the exact inverse: the port's parameters and running statistics as the
JAX package's tree of numpy arrays, so that tests compare updated weights
leaf by leaf.

`pretrained_loader_from_config(config)` is the trainer's hook for the
pretrained towers (wav2vec2 from `audio.path`, the video tower from
`data/in/<version>.pth`): where a file is absent it warns and keeps the
random init, as the JAX package does; where one is present it raises, since
the converters of those files come in a later slice.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from peppa_tpu_torch.models.layers import (BatchNorm, Conv, Dense, GroupNorm,
                                           LayerNorm)

# flax auto-names of the poolers -> the port's attribute name
_RENAME = {"AttentionPool_0": "pool", "VideoAttentionPool_0": "pool"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _walk(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _torch_name(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    mods = [_RENAME.get(m, m) for m in mods]
    if mods and mods[-1] == "bn":  # the JAX BatchNorm wraps flax's as "bn"
        mods = mods[:-1]
    return ".".join(mods + [_LEAF.get(leaf, leaf)])


def _to_torch_layout(leaf: str, x: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return x
    if x.ndim == 2:  # Dense (in, out)
        return x.T
    # Conv (*spatial, in, out) -> (out, in, *spatial)
    return np.transpose(x, (x.ndim - 1, x.ndim - 2) + tuple(range(x.ndim - 2)))


def load_jax_variables(model: nn.Module, variables: Dict[str, Any]) -> None:
    """Copy the JAX variables tree into `model` in place (see module doc)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    persistent = set(model.state_dict().keys())
    targets = {k: v for k, v in targets.items() if k in persistent}
    used = set()
    errors = []
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            name = _torch_name(path)
            if name not in targets:
                errors.append(f"unused leaf {collection}/{'/'.join(path)} "
                              f"(no {name})")
                continue
            value = _to_torch_layout(path[-1], value)
            target = targets[name]
            if tuple(value.shape) != tuple(target.shape):
                errors.append(f"{name}: shape {value.shape} from JAX, "
                              f"{tuple(target.shape)} in the port")
                continue
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.array(value, order="C")))
            used.add(name)
    extra = set(variables) - {"params", "batch_stats"}
    errors += [f"unused collection {c}" for c in sorted(extra)]
    errors += [f"missing {name}" for name in sorted(set(targets) - used)]
    if errors:
        raise ValueError("load_jax_variables: " + "; ".join(errors))


# module type -> {port leaf: (collection, JAX leaf)}
_EXPORT_LEAF = {
    Dense: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    Conv: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    LayerNorm: {"weight": ("params", "scale"), "bias": ("params", "bias")},
    GroupNorm: {"weight": ("params", "scale"), "bias": ("params", "bias")},
    BatchNorm: {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")},
}


def _from_torch_layout(leaf: str, x: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return x
    if x.ndim == 2:  # Linear (out, in) -> Dense (in, out)
        return x.T
    # Conv (out, in, *spatial) -> (*spatial, in, out)
    return np.transpose(x, tuple(range(2, x.ndim)) + (1, 0))


def _jax_path(model: nn.Module, name: str) -> Tuple[str, Tuple[str, ...]]:
    """(collection, JAX path) of the port's parameter or buffer `name`."""
    *mods, leaf = name.split(".")
    path = []
    for i, m in enumerate(mods):
        sub = model.get_submodule(".".join(mods[:i + 1]))
        path.append(f"{type(sub).__name__}_0"
                    if m == "pool" and f"{type(sub).__name__}_0" in _RENAME
                    else m)
    owner = model.get_submodule(".".join(mods)) if mods else model
    table = _EXPORT_LEAF.get(type(owner))
    if table is None:  # the positional conv's own parameters keep their names
        return "params", tuple(path) + (leaf,)
    collection, jax_leaf = table[leaf]
    if isinstance(owner, BatchNorm):  # the JAX BatchNorm wraps flax's as "bn"
        path.append("bn")
    return collection, tuple(path) + (jax_leaf,)


def export_jax_variables(model: nn.Module,
                         values: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, Any]:
    """The port's `{"params": ..., "batch_stats": ...}` in the JAX package's
    names and layouts, as nested dicts of float32 numpy arrays: the inverse
    of `load_jax_variables`.  `values` (name -> tensor, e.g. gradients)
    exports those tensors under the names of the model's own instead."""
    if values is None:
        values = {k: v for k, v in model.state_dict().items()}
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, tensor in values.items():
        collection, path = _jax_path(model, name)
        node = out[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        x = tensor.detach().float().cpu().numpy()
        node[path[-1]] = np.array(_from_torch_layout(path[-1], x), order="C")
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def pretrained_loader_from_config(config) -> Callable[[nn.Module], None]:
    """The hook the trainer applies to the freshly initialised model."""

    def load(model: nn.Module) -> None:
        paths = []
        if config.audio.pretrained:
            paths.append(("audio.pretrained", config.audio.path))
        if config.video.pretrained:
            version = ("static" if config.video.static
                       else config.video.version)
            paths.append(("video.pretrained", os.path.join(
                config.data.data_dir, "in", f"{version}.pth")))
        for key, path in paths:
            if os.path.exists(path):
                raise NotImplementedError(
                    f"{key}: loading {path} into the port comes in a later "
                    "slice; set it false to train from the random init")
            logging.warning("%s=True but %s not found; keeping random init",
                            key, path)

    return load
