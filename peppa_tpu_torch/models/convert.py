"""Carry the JAX package's variables across into the port's modules.

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

Any missing, unused or mis-shaped leaf raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

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
