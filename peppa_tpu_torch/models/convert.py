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

The reference's weights (the port's copies of peppa_tpu/models/convert.py's
numpy converters, each giving the JAX package's tree):

- `convert_wav2vec2_fairseq` (fairseq `wav2vec_small.pt`),
  `convert_video_resnet` (torchvision r2plus1d_18 / r3d_18 / mc3_18),
  `convert_resnet18` (torchvision ImageNet resnet18), `widen_midplanes`;
- `convert_wav2vec2_torchaudio` and `convert_peppa_state_dict` (a trained
  reference PeppaPig Lightning checkpoint), `load_peppa_checkpoint`;
- the exporters back (`export_*`, `save_reference_checkpoint`).

A converted tree goes into a port module as the JAX package puts it into
its variables: `export_jax_variables(model)`, the JAX package's merge, then
`load_jax_variables`.  A Lightning checkpoint merges recursively and keeps
only the leaves the model has (`_merge_intersect`); the pretrained files
replace whole subtrees after a shape check (`_merge_check`).  Torch files
are read by `load_torch_checkpoint`, which stubs the classes of packages
that are absent (Lightning, fairseq, omegaconf).

`pretrained_loader_from_config(config)` is the trainer's hook for the
pretrained towers (wav2vec2 from `audio.path`, the video tower from
`data/in/<version>.pth`, `static.pth` for the static encoder); where a
file is absent it warns and keeps the random init, as the JAX package does.

One difference from the JAX package: its `convert_resnet18` nests the stem
BatchNorm as `stem_bn/bn`, a name its static encoder does not have, so its
pretrained loader raises on that tree and its Lightning import drops the
stem BatchNorm (it keeps the init).  The port's `convert_resnet18` and
`export_resnet18` use the model's own `stem_bn` (ROADMAP, section C).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from peppa_tpu_torch.models.layers import (BatchNorm, Conv, Dense, GroupNorm,
                                           LayerNorm, PlainBatchNorm)
from peppa_tpu_torch.utils.device import resolve_device

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
            yield prefix + (key,), _np(value)


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
_EXPORT_LEAF[PlainBatchNorm] = _EXPORT_LEAF[BatchNorm]


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
        parent = model.get_submodule(".".join(mods[:i]))
        sub = model.get_submodule(".".join(mods[:i + 1]))
        auto = f"{type(sub).__name__}_0"  # flax's name of an unnamed module
        explicit = getattr(parent, "JAX_NAMES", {}).get(m)
        path.append(explicit or (auto if m == "pool" and auto in _RENAME
                                 else m))
    owner = model.get_submodule(".".join(mods)) if mods else model
    table = _EXPORT_LEAF.get(type(owner))
    if table is None:  # the positional conv's own parameters keep their names
        return "params", tuple(path) + (leaf,)
    collection, jax_leaf = table[leaf]
    if type(owner) is BatchNorm:  # the JAX BatchNorm wraps flax's as "bn"
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


# ------------------------------------------------ the reference's weights
def _np(t) -> np.ndarray:
    """A leaf as float32 numpy (torch tensors of any dtype, bf16 too)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def conv1d(w) -> np.ndarray:
    return _np(w).transpose(2, 1, 0)  # (O,I,K) -> (K,I,O)


def conv2d(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)  # (O,I,H,W) -> (H,W,I,O)


def conv3d(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 4, 1, 0)  # (O,I,T,H,W) -> (T,H,W,I,O)


def linear(w) -> np.ndarray:
    return _np(w).T  # (O,I) -> (I,O)


def _tolerant_pickle_module():
    """A pickle module whose Unpickler stubs the classes of absent packages
    (a Lightning checkpoint keys `callbacks` by the ModelCheckpoint class;
    fairseq blobs carry omegaconf objects) with dict subclasses: hashable
    as keys, and restorable from a dict-like state."""
    import io
    import pickle
    import types

    class _StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (dict,), {"__module__": module})

    mod = types.ModuleType("peppa_tolerant_pickle")
    mod.Unpickler = _StubUnpickler
    mod.load = lambda f, **kw: _StubUnpickler(f).load()
    mod.loads = lambda b, **kw: _StubUnpickler(io.BytesIO(b)).load()
    return mod


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """`torch.load` a reference file on the CPU, with the classes of absent
    packages stubbed (`weights_only=False`: it is a full pickle)."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_tolerant_pickle_module())


def _load_torch(path: str) -> Dict[str, Any]:
    """The state dict of a fairseq (`model`), Lightning (`state_dict`) or
    plain torchvision file."""
    blob = load_torch_checkpoint(path)
    if isinstance(blob, dict) and "model" in blob:
        return blob["model"]
    if isinstance(blob, dict) and "state_dict" in blob:
        return blob["state_dict"]
    return blob


# -------------------------------------------------------------- wav2vec2
def convert_wav2vec2_fairseq(state: Dict[str, Any]) -> Dict[str, Any]:
    """fairseq Wav2Vec2 state dict -> the wav2vec2 trunk's JAX tree (the
    28-d aux head is not in the file and keeps its init, as torchaudio's
    import_fairseq_model leaves it)."""
    p: Dict[str, Any] = {}
    fe: Dict[str, Any] = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.0.weight" in state:
        fe[f"conv{i}"] = {"kernel": conv1d(
            state[f"feature_extractor.conv_layers.{i}.0.weight"])}
        i += 1
    if "feature_extractor.conv_layers.0.2.weight" in state:
        fe["group_norm"] = {
            "scale": _np(state["feature_extractor.conv_layers.0.2.weight"]),
            "bias": _np(state["feature_extractor.conv_layers.0.2.bias"]),
        }
    p["feature_extractor"] = fe
    p["proj_ln"] = {"scale": _np(state["layer_norm.weight"]),
                    "bias": _np(state["layer_norm.bias"])}
    p["proj"] = {"kernel": linear(state["post_extract_proj.weight"]),
                 "bias": _np(state["post_extract_proj.bias"])}
    # weight norm over dim 2: v (O, I/g, K) and g (1, 1, K) -> (K, ., .)
    p["pos_conv"] = {
        "pos_conv_v": _np(state["encoder.pos_conv.0.weight_v"]
                          ).transpose(2, 1, 0),
        "pos_conv_g": _np(state["encoder.pos_conv.0.weight_g"]
                          ).transpose(2, 1, 0),
        "pos_conv_bias": _np(state["encoder.pos_conv.0.bias"]),
    }
    p["encoder_ln"] = {"scale": _np(state["encoder.layer_norm.weight"]),
                       "bias": _np(state["encoder.layer_norm.bias"])}
    i = 0
    while f"encoder.layers.{i}.self_attn.q_proj.weight" in state:
        pre = f"encoder.layers.{i}"
        p[f"layer{i}"] = {
            "attention": {
                name: {"kernel": linear(state[f"{pre}.self_attn.{name}.weight"]),
                       "bias": _np(state[f"{pre}.self_attn.{name}.bias"])}
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "ln1": {"scale": _np(state[f"{pre}.self_attn_layer_norm.weight"]),
                    "bias": _np(state[f"{pre}.self_attn_layer_norm.bias"])},
            "ffn_in": {"kernel": linear(state[f"{pre}.fc1.weight"]),
                       "bias": _np(state[f"{pre}.fc1.bias"])},
            "ffn_out": {"kernel": linear(state[f"{pre}.fc2.weight"]),
                        "bias": _np(state[f"{pre}.fc2.bias"])},
            "ln2": {"scale": _np(state[f"{pre}.final_layer_norm.weight"]),
                    "bias": _np(state[f"{pre}.final_layer_norm.bias"])},
        }
        i += 1
    return p


def convert_wav2vec2_torchaudio(state: Dict[str, Any]) -> Dict[str, Any]:
    """torchaudio Wav2Vec2Model state dict (the names inside a trained
    reference PeppaPig checkpoint, `audio_encoder.audio.` stripped) -> the
    wav2vec2 trunk's JAX tree, the trained aux head included."""
    p: Dict[str, Any] = {}
    fe: Dict[str, Any] = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in state:
        fe[f"conv{i}"] = {"kernel": conv1d(
            state[f"feature_extractor.conv_layers.{i}.conv.weight"])}
        i += 1
    if "feature_extractor.conv_layers.0.layer_norm.weight" in state:
        fe["group_norm"] = {
            "scale": _np(state["feature_extractor.conv_layers.0.layer_norm.weight"]),
            "bias": _np(state["feature_extractor.conv_layers.0.layer_norm.bias"]),
        }
    p["feature_extractor"] = fe
    fp = "encoder.feature_projection"
    if f"{fp}.layer_norm.weight" in state:
        p["proj_ln"] = {"scale": _np(state[f"{fp}.layer_norm.weight"]),
                        "bias": _np(state[f"{fp}.layer_norm.bias"])}
        p["proj"] = {"kernel": linear(state[f"{fp}.projection.weight"]),
                     "bias": _np(state[f"{fp}.projection.bias"])}
    # older torch stores weight_g/weight_v, newer the parametrization's
    # original0/original1
    pc = "encoder.transformer.pos_conv_embed.conv"
    wg_key, wv_key = f"{pc}.weight_g", f"{pc}.weight_v"
    if wg_key not in state:
        wg_key = f"{pc}.parametrizations.weight.original0"
        wv_key = f"{pc}.parametrizations.weight.original1"
    if wv_key in state:
        p["pos_conv"] = {
            "pos_conv_v": _np(state[wv_key]).transpose(2, 1, 0),
            "pos_conv_g": _np(state[wg_key]).transpose(2, 1, 0),
            "pos_conv_bias": _np(state[f"{pc}.bias"]),
        }
    if "encoder.transformer.layer_norm.weight" in state:
        p["encoder_ln"] = {
            "scale": _np(state["encoder.transformer.layer_norm.weight"]),
            "bias": _np(state["encoder.transformer.layer_norm.bias"])}
    i = 0
    while f"encoder.transformer.layers.{i}.attention.q_proj.weight" in state:
        pre = f"encoder.transformer.layers.{i}"
        p[f"layer{i}"] = {
            "attention": {
                name: {"kernel": linear(state[f"{pre}.attention.{name}.weight"]),
                       "bias": _np(state[f"{pre}.attention.{name}.bias"])}
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "ln1": {"scale": _np(state[f"{pre}.layer_norm.weight"]),
                    "bias": _np(state[f"{pre}.layer_norm.bias"])},
            "ffn_in": {"kernel": linear(
                state[f"{pre}.feed_forward.intermediate_dense.weight"]),
                "bias": _np(state[f"{pre}.feed_forward.intermediate_dense.bias"])},
            "ffn_out": {"kernel": linear(
                state[f"{pre}.feed_forward.output_dense.weight"]),
                "bias": _np(state[f"{pre}.feed_forward.output_dense.bias"])},
            "ln2": {"scale": _np(state[f"{pre}.final_layer_norm.weight"]),
                    "bias": _np(state[f"{pre}.final_layer_norm.bias"])},
        }
        i += 1
    if "aux.weight" in state:
        p["aux"] = {"kernel": linear(state["aux.weight"]),
                    "bias": _np(state["aux.bias"])}
    return p


# ------------------------------------------------------------ video resnets
def _bn(state, prefix: str) -> Dict[str, Any]:
    return {
        "params": {"scale": _np(state[f"{prefix}.weight"]),
                   "bias": _np(state[f"{prefix}.bias"])},
        "stats": {"mean": _np(state[f"{prefix}.running_mean"]),
                  "var": _np(state[f"{prefix}.running_var"])},
    }


def convert_video_resnet(state: Dict[str, Any], version: str):
    """torchvision VideoResNet state dict -> (params, batch_stats) trees.

    torchvision layouts: r2plus1d_18's stem is 0 conv (1,7,7), 1 bn,
    3 conv (3,1,1), 4 bn, and a block conv `convN.0` is the (2+1)D
    Sequential {0 conv, 1 bn, 3 conv}; r3d_18's and mc3_18's stem is 0 conv,
    1 bn, and a block conv `convN.0` is one conv.  The block BatchNorms are
    `convN.1`."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put_bn(tree_p, tree_s, name, src_prefix):
        bn = _bn(state, src_prefix)
        tree_p[name] = {"bn": bn["params"]}
        tree_s[name] = {"bn": bn["stats"]}

    if version == "r2plus1d_18":
        params["stem_spatial"] = {"kernel": conv3d(state["stem.0.weight"])}
        put_bn(params, stats, "stem_bn1", "stem.1")
        params["stem_temporal"] = {"kernel": conv3d(state["stem.3.weight"])}
        put_bn(params, stats, "stem_bn2", "stem.4")
    else:
        params["stem"] = {"kernel": conv3d(state["stem.0.weight"])}
        put_bn(params, stats, "stem_bn", "stem.1")

    for li in range(1, 5):
        for bi in range(2):
            src = f"layer{li}.{bi}"
            name = f"layer{li}_block{bi}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            if version == "r2plus1d_18":
                for conv in ("conv1", "conv2"):
                    mid = _bn(state, f"{src}.{conv}.0.1")
                    bp[conv] = {
                        "spatial": {"kernel": conv3d(
                            state[f"{src}.{conv}.0.0.weight"])},
                        "temporal": {"kernel": conv3d(
                            state[f"{src}.{conv}.0.3.weight"])},
                        "bn_mid": {"bn": mid["params"]}}
                    bs[conv] = {"bn_mid": {"bn": mid["stats"]}}
            else:
                for conv in ("conv1", "conv2"):
                    bp[conv] = {"conv": {"kernel": conv3d(
                        state[f"{src}.{conv}.0.weight"])}}
            put_bn(bp, bs, "bn1", f"{src}.conv1.1")
            put_bn(bp, bs, "bn2", f"{src}.conv2.1")
            if f"{src}.downsample.0.weight" in state:
                bp["downsample"] = {"kernel": conv3d(
                    state[f"{src}.downsample.0.weight"])}
                put_bn(bp, bs, "bn_down", f"{src}.downsample.1")
            params[name] = bp
            stats[name] = bs
    return params, stats


def convert_resnet18(state: Dict[str, Any]):
    """torchvision resnet18 state dict -> (params, batch_stats) trees of
    the static encoder's trunk (flax BatchNorms, no "bn" wrapper; module
    doc)."""
    params: Dict[str, Any] = {"stem_conv": {"kernel": conv2d(
        state["conv1.weight"])}}
    stats: Dict[str, Any] = {}
    bn = _bn(state, "bn1")
    params["stem_bn"] = bn["params"]
    stats["stem_bn"] = bn["stats"]
    for li in range(1, 5):
        for bi in range(2):
            src = f"layer{li}.{bi}"
            name = f"layer{li}_block{bi}"
            bp = {"conv1": {"kernel": conv2d(state[f"{src}.conv1.weight"])},
                  "conv2": {"kernel": conv2d(state[f"{src}.conv2.weight"])}}
            bs = {}
            for bn_name in ("bn1", "bn2"):
                b = _bn(state, f"{src}.{bn_name}")
                bp[bn_name] = b["params"]
                bs[bn_name] = b["stats"]
            if f"{src}.downsample.0.weight" in state:
                bp["downsample"] = {"kernel": conv2d(
                    state[f"{src}.downsample.0.weight"])}
                b = _bn(state, f"{src}.downsample.1")
                bp["bn_down"] = b["params"]
                bs["bn_down"] = b["stats"]
            params[name] = bp
            stats[name] = bs
    return params, stats


def _deep_copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _deep_copy_tree(v) for k, v in tree.items()}
    return tree


def widen_midplanes(params: Dict[str, Any], stats: Dict[str, Any],
                    multiple: int) -> tuple:
    """Adapt converted r2plus1d_18 trees to `midplanes_multiple=multiple`.

    Where a block's mid width grows, the mid channels are zero-padded
    (spatial kernel outputs and temporal kernel inputs 0, BatchNorm scale 1,
    bias 0, mean 0, var 1): the same function, exactly.  Where it shrinks,
    the m_new most important mid channels are kept, importance_j =
    ||spatial[..., j]|| * |scale_j| / sqrt(var_j + 1e-5) *
    ||temporal[:, :, :, j, :]||: an approximation.  Trees that are not
    r2plus1d's pass through."""
    from peppa_tpu_torch.models.video3d import midplanes as mid_of

    params = _deep_copy_tree(params)
    stats = _deep_copy_tree(stats)
    widths = {1: (64, 64), 2: (64, 128), 3: (128, 256), 4: (256, 512)}
    for li in range(1, 5):
        for bi in range(2):
            name = f"layer{li}_block{bi}"
            if name not in params or "spatial" not in params[name].get(
                    "conv1", {}):
                continue
            c_in = widths[li][0] if bi == 0 else widths[li][1]
            m_new = mid_of(c_in, widths[li][1], multiple)
            # torchvision computes midplanes once per block, for both convs
            for conv in ("conv1", "conv2"):
                blk = params[name][conv]
                bnp = blk["bn_mid"]["bn"]
                bns = stats[name][conv]["bn_mid"]["bn"]
                m_old = blk["spatial"]["kernel"].shape[-1]
                if m_old == m_new:
                    continue
                if m_new > m_old:
                    pad = m_new - m_old
                    blk["spatial"]["kernel"] = np.pad(
                        blk["spatial"]["kernel"], [(0, 0)] * 4 + [(0, pad)])
                    blk["temporal"]["kernel"] = np.pad(
                        blk["temporal"]["kernel"],
                        [(0, 0)] * 3 + [(0, pad), (0, 0)])
                    bnp["scale"] = np.pad(bnp["scale"], (0, pad),
                                          constant_values=1.0)
                    bnp["bias"] = np.pad(bnp["bias"], (0, pad))
                    bns["mean"] = np.pad(bns["mean"], (0, pad))
                    bns["var"] = np.pad(bns["var"], (0, pad),
                                        constant_values=1.0)
                else:
                    spatial = np.asarray(blk["spatial"]["kernel"])
                    temporal = np.asarray(blk["temporal"]["kernel"])
                    gain = np.abs(np.asarray(bnp["scale"])) / np.sqrt(
                        np.asarray(bns["var"]) + 1e-5)
                    importance = (
                        np.linalg.norm(spatial.reshape(-1, m_old), axis=0)
                        * gain
                        * np.linalg.norm(temporal.transpose(3, 0, 1, 2, 4)
                                         .reshape(m_old, -1), axis=1))
                    keep = np.sort(np.argsort(importance)[-m_new:])
                    blk["spatial"]["kernel"] = spatial[..., keep]
                    blk["temporal"]["kernel"] = temporal[:, :, :, keep, :]
                    bnp["scale"] = np.asarray(bnp["scale"])[keep]
                    bnp["bias"] = np.asarray(bnp["bias"])[keep]
                    bns["mean"] = np.asarray(bns["mean"])[keep]
                    bns["var"] = np.asarray(bns["var"])[keep]
    return params, stats


# ---------------------------------------- trained reference checkpoints
def _attention_pool(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The reference's Attention module -> the AttentionPool tree."""
    return {
        "hidden": {"kernel": linear(state[f"{prefix}hidden.weight"]),
                   "bias": _np(state[f"{prefix}hidden.bias"])},
        "out": {"kernel": linear(state[f"{prefix}out.weight"]),
                "bias": _np(state[f"{prefix}out.bias"])},
    }


def convert_peppa_state_dict(state: Dict[str, Any], config) -> tuple:
    """A trained reference PeppaPig state_dict -> (params, batch_stats) of
    both towers, their pools and projections."""

    def sub(prefix: str) -> Dict[str, Any]:
        return {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    a: Dict[str, Any] = {"wav2vec2": convert_wav2vec2_torchaudio(
        sub("audio_encoder.audio."))}
    if config.audio.pooling == "attention":
        a["AttentionPool_0"] = _attention_pool(state, "audio_encoder.audiopool.")
    if config.audio.project and "audio_encoder.project.weight" in state:
        a["project"] = {"kernel": linear(state["audio_encoder.project.weight"]),
                        "bias": _np(state["audio_encoder.project.bias"])}
    params["audio_encoder"] = a

    v: Dict[str, Any] = {}
    vs: Dict[str, Any] = {}
    if config.video.static:
        v["trunk"], vs["trunk"] = convert_resnet18(sub("video_encoder.image."))
        if config.video.pooling == "attention":
            v["pool"] = _attention_pool(state, "video_encoder.pool.")
    else:
        v["trunk"], vs["trunk"] = convert_video_resnet(
            sub("video_encoder.video."), config.video.version)
        if config.video.midplanes_multiple:
            v["trunk"], vs["trunk"] = widen_midplanes(
                v["trunk"], vs["trunk"], config.video.midplanes_multiple)
        if config.video.pooling == "attention":
            v["VideoAttentionPool_0"] = {"attn": _attention_pool(
                state, "video_encoder.videopool.attn.")}
    if config.video.project and "video_encoder.project.weight" in state:
        v["project"] = {"kernel": linear(state["video_encoder.project.weight"]),
                        "bias": _np(state["video_encoder.project.bias"])}
    params["video_encoder"] = v
    stats["video_encoder"] = vs
    return params, stats


def _merge_intersect(dst: Dict[str, Any], src: Dict[str, Any], scope: str,
                     dropped: list) -> None:
    """Merge `src` into `dst` recursively, shape-checked; keys the model
    tree lacks (the transformer under `audio.full: false`, the unused
    classifier heads) are skipped and listed in `dropped`."""
    for k, v in src.items():
        if k not in dst:
            dropped.append(f"{scope}/{k}")
            continue
        if isinstance(v, dict) and isinstance(dst[k], dict):
            _merge_intersect(dst[k], v, f"{scope}/{k}", dropped)
        else:
            want, got = tuple(np.shape(dst[k])), tuple(np.shape(v))
            if want != got:
                raise ValueError(f"Shape mismatch at {scope}/{k}: model "
                                 f"{want} vs checkpoint {got}")
            dst[k] = v


def load_peppa_checkpoint(path: str, config=None,
                          device: Optional[Union[str, torch.device]] = None):
    """A trained reference PeppaPig Lightning checkpoint as the port's
    model: (model in eval mode on `device`, config, meta).  The config is
    the checkpoint's embedded `hyper_parameters` unless one is passed.
    Leaves the file lacks keep the init of `init_model(config, seed=0)`;
    leaves the model lacks are dropped (and logged)."""
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.models.dual_encoder import init_model

    blob = load_torch_checkpoint(path)
    state = blob.get("state_dict", blob)
    if config is None:
        hp = blob.get("hyper_parameters")
        if hp is None:
            raise ValueError(f"{path} embeds no hyper_parameters; "
                             "pass config= explicitly")
        config = Config.from_dict(dict(hp))
    p_new, s_new = convert_peppa_state_dict(state, config)
    if not p_new["audio_encoder"]["wav2vec2"].get("feature_extractor") or \
            not p_new["video_encoder"].get("trunk"):
        raise ValueError(
            f"{path}: state_dict does not look like a PeppaPig checkpoint "
            "(no audio feature extractor / video trunk weights found)")
    model = init_model(config, seed=0, device="cpu")
    variables = export_jax_variables(model)
    dropped: list = []
    _merge_intersect(variables["params"], p_new, "params", dropped)
    if "batch_stats" in variables:
        _merge_intersect(variables["batch_stats"], s_new, "batch_stats",
                         dropped)
    if dropped:
        logging.info("Checkpoint import: %d tensors not in the model tree "
                     "(first: %s)", len(dropped), dropped[0])
    load_jax_variables(model, variables)
    meta = {k: blob.get(k) for k in ("epoch", "global_step") if k in blob}
    return model.to(resolve_device(device)), config, meta


# ------------------------------------------------------ pretrained files
def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def _merge_check(dst: Dict[str, Any], src: Dict[str, Any], scope: str) -> None:
    """Each converted subtree must exist in the model tree with the same
    structure and shapes."""
    for k in src:
        if k not in dst:
            raise KeyError(f"Converted key {scope}/{k} missing in model tree")
        if _shape_tree(dst[k]) != _shape_tree(src[k]):
            raise ValueError(
                f"Shape mismatch at {scope}/{k}: model {_shape_tree(dst[k])} "
                f"vs checkpoint {_shape_tree(src[k])}")


def load_wav2vec2_pretrained(path: str, variables: Dict[str, Any],
                             scope: str = "audio_encoder") -> Dict[str, Any]:
    """`variables` with the fairseq file's trunk subtrees in place."""
    trunk = convert_wav2vec2_fairseq(_load_torch(path))
    out = _deep_copy_tree(variables)
    merged = out["params"][scope]["wav2vec2"]
    _merge_check(merged, trunk, f"{scope}/wav2vec2")
    merged.update(trunk)
    return out


def load_video_pretrained(path: str, variables: Dict[str, Any], version: str,
                          scope: str = "video_encoder",
                          midplanes_multiple: Optional[int] = None
                          ) -> Dict[str, Any]:
    """`variables` with the torchvision file's trunk subtrees in place
    (`version` "static" reads a resnet18)."""
    state = _load_torch(path)
    if version == "static":
        p, s = convert_resnet18(state)
    else:
        p, s = convert_video_resnet(state, version)
        if midplanes_multiple:
            p, s = widen_midplanes(p, s, midplanes_multiple)
    out = _deep_copy_tree(variables)
    trunk = out["params"][scope]["trunk"]
    _merge_check(trunk, p, f"{scope}/trunk")
    trunk.update(p)
    if out.get("batch_stats"):
        out["batch_stats"].setdefault(scope, {}).setdefault(
            "trunk", {}).update(s)
    return out


def pretrained_loader_from_config(config) -> Callable[[nn.Module], None]:
    """The hook the trainer applies to the freshly initialised model: the
    fairseq wav2vec2 file at `audio.path` and the torchvision file at
    `data/in/<version>.pth` (`static.pth` under `video.static`), each where
    the config asks for it and the file is present; an absent file warns
    and keeps the random init."""

    def load(model: nn.Module) -> None:
        variables = export_jax_variables(model)
        changed = False
        if config.audio.pretrained:
            path = config.audio.path
            if os.path.exists(path):
                logging.info("Loading pretrained wav2vec2 from %s", path)
                variables = load_wav2vec2_pretrained(path, variables)
                changed = True
            else:
                logging.warning("audio.pretrained=True but %s not found; "
                                "keeping random init", path)
        if config.video.pretrained:
            version = "static" if config.video.static else config.video.version
            path = os.path.join(config.data.data_dir, "in", f"{version}.pth")
            if os.path.exists(path):
                logging.info("Loading pretrained video weights from %s", path)
                variables = load_video_pretrained(
                    path, variables, version,
                    midplanes_multiple=config.video.midplanes_multiple)
                changed = True
            else:
                logging.warning("video.pretrained=True but %s not found; "
                                "keeping random init", path)
        if changed:
            load_jax_variables(model, variables)

    return load


# ------------------------------------------- back: JAX tree -> reference
def _t(a) -> torch.Tensor:
    return torch.tensor(_np(a))


def linear_inv(k) -> torch.Tensor:
    return _t(_np(k).T)  # (I,O) -> (O,I)


def conv1d_inv(k) -> torch.Tensor:
    return _t(np.transpose(_np(k), (2, 1, 0)))  # (K,I,O) -> (O,I,K)


def conv2d_inv(k) -> torch.Tensor:
    return _t(np.transpose(_np(k), (3, 2, 0, 1)))  # (H,W,I,O) -> (O,I,H,W)


def conv3d_inv(k) -> torch.Tensor:
    return _t(np.transpose(_np(k), (4, 3, 0, 1, 2)))  # -> (O,I,T,H,W)


def _export_bn(out: Dict[str, Any], prefix: str, bn_p: Dict[str, Any],
               bn_s: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(bn_p["scale"])
    out[f"{prefix}.bias"] = _t(bn_p["bias"])
    out[f"{prefix}.running_mean"] = _t(bn_s["mean"])
    out[f"{prefix}.running_var"] = _t(bn_s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _export_attention_pool(out: Dict[str, Any], prefix: str,
                           pool: Dict[str, Any]) -> None:
    out[f"{prefix}hidden.weight"] = linear_inv(pool["hidden"]["kernel"])
    out[f"{prefix}hidden.bias"] = _t(pool["hidden"]["bias"])
    out[f"{prefix}out.weight"] = linear_inv(pool["out"]["kernel"])
    out[f"{prefix}out.bias"] = _t(pool["out"]["bias"])


def export_wav2vec2_torchaudio(p: Dict[str, Any]) -> Dict[str, Any]:
    """The wav2vec2 trunk's JAX tree -> torchaudio names: the inverse of
    `convert_wav2vec2_torchaudio`, the positional conv as `weight_g` /
    `weight_v` (the reference's torch 1.9 names)."""
    out: Dict[str, Any] = {}
    fe = p["feature_extractor"]
    i = 0
    while f"conv{i}" in fe:
        out[f"feature_extractor.conv_layers.{i}.conv.weight"] = \
            conv1d_inv(fe[f"conv{i}"]["kernel"])
        i += 1
    if "group_norm" in fe:
        out["feature_extractor.conv_layers.0.layer_norm.weight"] = \
            _t(fe["group_norm"]["scale"])
        out["feature_extractor.conv_layers.0.layer_norm.bias"] = \
            _t(fe["group_norm"]["bias"])
    if "proj_ln" in p:
        fp = "encoder.feature_projection"
        out[f"{fp}.layer_norm.weight"] = _t(p["proj_ln"]["scale"])
        out[f"{fp}.layer_norm.bias"] = _t(p["proj_ln"]["bias"])
        out[f"{fp}.projection.weight"] = linear_inv(p["proj"]["kernel"])
        out[f"{fp}.projection.bias"] = _t(p["proj"]["bias"])
    if "pos_conv" in p:
        pc = "encoder.transformer.pos_conv_embed.conv"
        out[f"{pc}.weight_v"] = _t(np.transpose(
            _np(p["pos_conv"]["pos_conv_v"]), (2, 1, 0)))
        out[f"{pc}.weight_g"] = _t(np.transpose(
            _np(p["pos_conv"]["pos_conv_g"]), (2, 1, 0)))
        out[f"{pc}.bias"] = _t(p["pos_conv"]["pos_conv_bias"])
    if "encoder_ln" in p:
        out["encoder.transformer.layer_norm.weight"] = \
            _t(p["encoder_ln"]["scale"])
        out["encoder.transformer.layer_norm.bias"] = _t(p["encoder_ln"]["bias"])
    i = 0
    while f"layer{i}" in p:
        lp = p[f"layer{i}"]
        pre = f"encoder.transformer.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{pre}.attention.{name}.weight"] = \
                linear_inv(lp["attention"][name]["kernel"])
            out[f"{pre}.attention.{name}.bias"] = \
                _t(lp["attention"][name]["bias"])
        out[f"{pre}.layer_norm.weight"] = _t(lp["ln1"]["scale"])
        out[f"{pre}.layer_norm.bias"] = _t(lp["ln1"]["bias"])
        out[f"{pre}.feed_forward.intermediate_dense.weight"] = \
            linear_inv(lp["ffn_in"]["kernel"])
        out[f"{pre}.feed_forward.intermediate_dense.bias"] = \
            _t(lp["ffn_in"]["bias"])
        out[f"{pre}.feed_forward.output_dense.weight"] = \
            linear_inv(lp["ffn_out"]["kernel"])
        out[f"{pre}.feed_forward.output_dense.bias"] = _t(lp["ffn_out"]["bias"])
        out[f"{pre}.final_layer_norm.weight"] = _t(lp["ln2"]["scale"])
        out[f"{pre}.final_layer_norm.bias"] = _t(lp["ln2"]["bias"])
        i += 1
    if "aux" in p:
        out["aux.weight"] = linear_inv(p["aux"]["kernel"])
        out["aux.bias"] = _t(p["aux"]["bias"])
    return out


def export_video_resnet(p: Dict[str, Any], s: Dict[str, Any], version: str,
                        prefix: str) -> Dict[str, Any]:
    """The video trunk's (params, batch_stats) -> torchvision VideoResNet
    names: the inverse of `convert_video_resnet`, with the unused 400-way
    Kinetics head as zeros."""
    out: Dict[str, Any] = {}
    if version == "r2plus1d_18":
        out[f"{prefix}stem.0.weight"] = conv3d_inv(p["stem_spatial"]["kernel"])
        _export_bn(out, f"{prefix}stem.1", p["stem_bn1"]["bn"],
                   s["stem_bn1"]["bn"])
        out[f"{prefix}stem.3.weight"] = conv3d_inv(p["stem_temporal"]["kernel"])
        _export_bn(out, f"{prefix}stem.4", p["stem_bn2"]["bn"],
                   s["stem_bn2"]["bn"])
    else:
        out[f"{prefix}stem.0.weight"] = conv3d_inv(p["stem"]["kernel"])
        _export_bn(out, f"{prefix}stem.1", p["stem_bn"]["bn"],
                   s["stem_bn"]["bn"])
    for li in range(1, 5):
        for bi in range(2):
            bp, bs = p[f"layer{li}_block{bi}"], s[f"layer{li}_block{bi}"]
            dst = f"{prefix}layer{li}.{bi}"
            for conv in ("conv1", "conv2"):
                if version == "r2plus1d_18":
                    out[f"{dst}.{conv}.0.0.weight"] = \
                        conv3d_inv(bp[conv]["spatial"]["kernel"])
                    _export_bn(out, f"{dst}.{conv}.0.1",
                               bp[conv]["bn_mid"]["bn"],
                               bs[conv]["bn_mid"]["bn"])
                    out[f"{dst}.{conv}.0.3.weight"] = \
                        conv3d_inv(bp[conv]["temporal"]["kernel"])
                else:
                    out[f"{dst}.{conv}.0.weight"] = \
                        conv3d_inv(bp[conv]["conv"]["kernel"])
            _export_bn(out, f"{dst}.conv1.1", bp["bn1"]["bn"], bs["bn1"]["bn"])
            _export_bn(out, f"{dst}.conv2.1", bp["bn2"]["bn"], bs["bn2"]["bn"])
            if "downsample" in bp:
                out[f"{dst}.downsample.0.weight"] = \
                    conv3d_inv(bp["downsample"]["kernel"])
                _export_bn(out, f"{dst}.downsample.1", bp["bn_down"]["bn"],
                           bs["bn_down"]["bn"])
    out[f"{prefix}fc.weight"] = torch.zeros(400, 512)
    out[f"{prefix}fc.bias"] = torch.zeros(400)
    return out


def export_resnet18(p: Dict[str, Any], s: Dict[str, Any],
                    prefix: str) -> Dict[str, Any]:
    """The static trunk -> torchvision resnet18 names: the inverse of
    `convert_resnet18`, with the unused 1000-way ImageNet head as zeros."""
    out: Dict[str, Any] = {f"{prefix}conv1.weight":
                           conv2d_inv(p["stem_conv"]["kernel"])}
    _export_bn(out, f"{prefix}bn1", p["stem_bn"], s["stem_bn"])
    for li in range(1, 5):
        for bi in range(2):
            bp, bs = p[f"layer{li}_block{bi}"], s[f"layer{li}_block{bi}"]
            dst = f"{prefix}layer{li}.{bi}"
            out[f"{dst}.conv1.weight"] = conv2d_inv(bp["conv1"]["kernel"])
            out[f"{dst}.conv2.weight"] = conv2d_inv(bp["conv2"]["kernel"])
            _export_bn(out, f"{dst}.bn1", bp["bn1"], bs["bn1"])
            _export_bn(out, f"{dst}.bn2", bp["bn2"], bs["bn2"])
            if "downsample" in bp:
                out[f"{dst}.downsample.0.weight"] = \
                    conv2d_inv(bp["downsample"]["kernel"])
                _export_bn(out, f"{dst}.downsample.1", bp["bn_down"],
                           bs["bn_down"])
    out[f"{prefix}fc.weight"] = torch.zeros(1000, 512)
    out[f"{prefix}fc.bias"] = torch.zeros(1000)
    return out


def export_peppa_state_dict(variables: Dict[str, Any], config
                            ) -> Dict[str, Any]:
    """The JAX-layout variables (`export_jax_variables(model)`) -> a
    reference PeppaPig state_dict: the inverse of
    `convert_peppa_state_dict`."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, Any] = {}
    a = params["audio_encoder"]
    if not config.audio.full:
        raise ValueError(
            "export requires audio.full=True: a full=False model has no "
            "transformer, but the reference's torchaudio wrapper always "
            "holds one")
    for k, v in export_wav2vec2_torchaudio(a["wav2vec2"]).items():
        out[f"audio_encoder.audio.{k}"] = v
    if config.audio.pooling == "attention":
        _export_attention_pool(out, "audio_encoder.audiopool.",
                               a["AttentionPool_0"])
    if config.audio.project and "project" in a:
        out["audio_encoder.project.weight"] = linear_inv(a["project"]["kernel"])
        out["audio_encoder.project.bias"] = _t(a["project"]["bias"])

    v = params["video_encoder"]
    vs = stats.get("video_encoder", {})
    if config.video.static:
        for k, t in export_resnet18(v["trunk"], vs["trunk"], "").items():
            out[f"video_encoder.image.{k}"] = t
        if config.video.pooling == "attention":
            _export_attention_pool(out, "video_encoder.pool.", v["pool"])
    else:
        trunk_p, trunk_s = v["trunk"], vs["trunk"]
        if config.video.midplanes_multiple:
            # back to the torchvision widths (approximate where it shrinks)
            trunk_p, trunk_s = widen_midplanes(trunk_p, trunk_s, 1)
        for k, t in export_video_resnet(trunk_p, trunk_s,
                                        config.video.version, "").items():
            out[f"video_encoder.video.{k}"] = t
        if config.video.pooling == "attention":
            _export_attention_pool(out, "video_encoder.videopool.attn.",
                                   v["VideoAttentionPool_0"]["attn"])
    if config.video.project and "project" in v:
        out["video_encoder.project.weight"] = linear_inv(v["project"]["kernel"])
        out["video_encoder.project.bias"] = _t(v["project"]["bias"])
    return out


def _model_checkpoint_class():
    """The class Lightning keys a checkpoint's callback state by:
    Lightning's own when it is installed, else a stub registered under its
    module path for the time of the save, so that the pickle records
    `pytorch_lightning.callbacks.model_checkpoint.ModelCheckpoint`.
    Returns (class, the module names to remove after)."""
    import sys
    import types

    try:
        from pytorch_lightning.callbacks.model_checkpoint import \
            ModelCheckpoint  # type: ignore
        return ModelCheckpoint, []
    except ImportError:
        names = ("pytorch_lightning", "pytorch_lightning.callbacks",
                 "pytorch_lightning.callbacks.model_checkpoint")
        created = []
        for name in names:
            if name not in sys.modules:
                sys.modules[name] = types.ModuleType(name)
                created.append(name)

        class ModelCheckpoint:  # noqa: N801 - Lightning's name
            pass

        ModelCheckpoint.__module__ = names[-1]
        ModelCheckpoint.__qualname__ = "ModelCheckpoint"
        sys.modules[names[-1]].ModelCheckpoint = ModelCheckpoint
        return ModelCheckpoint, created


# the keys the reference's constructors take (pig/models.py): the
# extension keys would raise there
_REF_AUDIO = ("path", "pretrained", "freeze_feature_extractor",
              "freeze_encoder_layers", "pooling", "project", "full")
_REF_VIDEO = ("pretrained", "project", "version", "pooling", "static")


def save_reference_checkpoint(path: str, variables: Dict[str, Any], config,
                              *, epoch: int = 0, global_step: int = 0,
                              monitor: Optional[str] = None,
                              score: Optional[float] = None) -> str:
    """Write a reference-format Lightning `.ckpt` of JAX-layout variables:
    `state_dict` (reference names), `hyper_parameters` (the reference's
    config keys), `epoch`, `global_step`, and with `monitor` and `score` a
    ModelCheckpoint callbacks entry that ranks the file."""
    import sys

    hparams = {k: v for k, v in config.to_dict().items() if k != "tpu"}
    hparams["audio"] = {k: v for k, v in hparams["audio"].items()
                        if k in _REF_AUDIO}
    hparams["video"] = {k: v for k, v in hparams["video"].items()
                        if k in _REF_VIDEO}
    blob: Dict[str, Any] = {
        "state_dict": export_peppa_state_dict(variables, config),
        "hyper_parameters": hparams,
        "epoch": int(epoch),
        "global_step": int(global_step),
    }
    cleanup: list = []
    try:
        if monitor is not None and score is not None:
            cls, cleanup = _model_checkpoint_class()
            blob["callbacks"] = {cls: {
                "monitor": monitor,
                "best_model_score": torch.tensor(float(score)),
                "best_model_path": os.path.abspath(path),
            }}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(blob, path)
    finally:
        for name in cleanup:
            sys.modules.pop(name, None)
    return path
