"""A rank of the port's two-process tests on the CPU (gloo).

    python tests/torch_port_dist_worker.py JOB RANK WORLD PORT DIR

joins a group of WORLD processes on 127.0.0.1:PORT through the port's
`init_distributed` (with the variables `torchrun` would set; none when
WORLD is 1), runs JOB on the inputs the test wrote to DIR/inputs.pkl and
writes DIR/JOB_RANK.pkl:

- "parallel" (tests/test_torch_port_parallel.py): the global-negative
  loss and the gathered-rows loss with their gradients, a synchronised
  BatchNorm, the global moments over more than 2^24 values, the bucketed gradient all-reduce, two micro-steps of the
  tiny configuration's `train_step` (and one under
  `tpu.global_negative_loss: false`), and the dropout and layer-drop
  streams;
- "multihost" (tests/test_torch_port_multihost.py): `Trainer.fit` with
  `data.prepare` (refused), then four ways in the same group: straight;
  with rank 1's clock past `max_time`
  after its second micro-step; with rank 1 signalled (SIGTERM) after its
  third; and resumed from that run's preempted.ckpt;
- "one" (WORLD 1): the "parallel" job's micro-steps on the whole global
  batches, in one process with no group;
- "remat" (tests/test_torch_port_remat.py): two micro-steps (k = 2: an
  optimizer step) of `remat_raw`'s configuration with `tpu.remat_audio` / `remat_video` off
  and then on: the losses, the means handed to BertAdam, the state's
  digest and the checkpoint calls of each;
- "tp_train" (WORLD 4, a (2, 2) mesh) and "tp_one" (WORLD 1)
  (tests/test_torch_port_tensor_parallel.py): two micro-steps of
  `tp_raw`'s configuration, its transformer split over 'model', and the
  same steps in one process;
- "tp_pair" (WORLD 2, a (1, 2) mesh;
  tests/test_torch_port_tensor_parallel_pair.py): `replicate_tree`, the
  split forward in float32, bf16 and int8, the clip of a split parameter,
  the default rates' micro-steps;
- "tp_serve" (WORLD 2; tests/test_torch_port_tensor_parallel_serve.py):
  a checkpoint written on a (1, 2) mesh and resumed on a (2, 1) mesh and
  in one process, and `EncoderService` over the (2, 1) mesh's data axis;
  rank 0 of "tp_pair" and "tp_serve" also runs each case in one process.

Imports torch and the port only (no JAX).  The configurations and batches
come from the functions below, which the tests import too, so that both
sides are built alike.
"""

import contextlib
import functools
import hashlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B_GLOBAL, FRAMES, SAMPLES = 8, 8, 1280  # the train step's global batch
FIT_B, FIT_TRAIN, FIT_EPOCHS = 2, 16, 2  # per rank; 4 global steps a epoch
BIG_ROWS = (1 << 23) + 1  # a rank's rows: over 2^24 a channel on two ranks


def tiny_raw(data_dir: str) -> dict:
    """tests/test_training_loop.py's tiny_config for both packages'
    `Config.from_dict`: 32x32 frames, 1600 Hz, the conv-only audio trunk,
    r3d_18, float32; k = 2 and a constant learning rate (`t_total: -1`),
    so that the second micro-step's optimizer step moves the parameters."""
    return {
        "data": {"target_size": [32, 32], "audio_sample_rate": 1600,
                 "data_dir": data_dir,
                 "train": {"batch_size": 4, "duration": 0.8},
                 "val": {"batch_size": 4, "duration": 0.8}},
        "audio": {"full": False},
        "video": {"version": "r3d_18"},
        "training": {"trainer_args": {"precision": 32,
                                      "accumulate_grad_batches": 2}},
        "optimizer": {"t_total": -1},
        "tpu": {"bucket_durations": [0.8, 2.0]},
    }


def fit_raw(data_dir: str, batch_size: int = FIT_B) -> dict:
    """The fits' configuration: the tiny one with mc3_18 (a third of
    r3d_18's parameters, so a checkpoint is about 0.25 GB), `batch_size`
    clips a rank, k = 2, two epochs of every synthetic clip, a warm-up of
    10 of 100 optimizer steps."""
    raw = tiny_raw(data_dir)
    raw["video"]["version"] = "mc3_18"
    raw["data"]["train"]["batch_size"] = batch_size
    raw["training"].update(max_epochs=FIT_EPOCHS, num_sanity_val_steps=1,
                           limit_val_batches=2, log_every_n_steps=1,
                           max_time="00:01:00:00")
    raw["optimizer"]["t_total"] = 100
    return raw


def remat_raw(data_dir: str) -> dict:
    """The tiny configuration with the full audio trunk (one transformer
    layer) and every stochastic rate at 0.1: dropout and layer-drop, and
    synchronised BatchNorm (mc3_18's), under the recompute."""
    raw = tiny_raw(data_dir)
    raw["audio"] = {"full": True, "num_layers": 1, "dropout": 0.1}
    raw["video"]["version"] = "mc3_18"
    return raw


# the transformer of the tensor-parallel tests: 4 heads and 64 FFN columns
TP_AUDIO = dict(embed_dim=32, num_heads=4, ffn_dim=64, pos_conv_kernel=8,
                pos_conv_groups=4)
MESHES = {"tp_train": (2, 2), "tp_pair": (1, 2), "tp_serve": (2, 1)}


def tp_raw(data_dir: str, mesh_shape=(2, 2)) -> dict:
    """The tiny configuration with the full audio trunk (two transformer
    layers, `TP_AUDIO`'s widths under `small_transformer`),
    `audio.dropout: 0.0`, mc3_18 (a third of r3d_18's parameters) and
    `tpu.mesh_shape`."""
    raw = tiny_raw(data_dir)
    raw["audio"] = {"full": True, "num_layers": 2, "dropout": 0.0}
    raw["video"]["version"] = "mc3_18"
    raw["tpu"]["mesh_shape"] = list(mesh_shape)
    return raw


@contextlib.contextmanager
def small_transformer(module):
    """`module.Wav2Vec2Config` (either package's models/dual_encoder.py)
    with `TP_AUDIO`'s widths, for the `with` block."""
    real = module.Wav2Vec2Config
    module.Wav2Vec2Config = functools.partial(real, **TP_AUDIO)
    try:
        yield
    finally:
        module.Wav2Vec2Config = real


def global_batches(n: int = 2) -> list:
    """`n` global batches of B_GLOBAL rows (dicts of numpy arrays)."""
    rng = np.random.default_rng(0)
    return [dict(
        video=rng.integers(0, 256, size=(B_GLOBAL, FRAMES, 32, 32, 3))
        .astype(np.uint8),
        audio=rng.normal(scale=0.1, size=(B_GLOBAL, SAMPLES))
        .astype(np.float32),
        video_frames=rng.integers(FRAMES // 2, FRAMES + 1, size=B_GLOBAL)
        .astype(np.int32),
        audio_samples=rng.integers(SAMPLES // 2, SAMPLES + 1, size=B_GLOBAL)
        .astype(np.int32),
        video_duration=np.full((B_GLOBAL,), 0.8, np.float32),
        audio_duration=np.full((B_GLOBAL,), 0.8, np.float32))
        for _ in range(n)]


def big_rows(rank: int) -> np.ndarray:
    """Rank `rank`'s (BIG_ROWS, 1) float32 values for the moments above
    2^24 values a channel."""
    return np.random.default_rng(10 + rank).normal(
        0.5, 1.0, size=(BIG_ROWS, 1)).astype(np.float32)


def small_wav2vec2(**rates):
    """A 4-layer wav2vec2 of width 32 with seeded weights."""
    import torch

    from peppa_tpu_torch.models.wav2vec2 import Wav2Vec2, Wav2Vec2Config

    model = Wav2Vec2(Wav2Vec2Config(
        embed_dim=32, num_layers=4, num_heads=4, ffn_dim=64, num_out=8,
        pos_conv_kernel=8, pos_conv_groups=4, **rates))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def state_digest(state_dict) -> str:
    """sha256 over every tensor's bytes, in order."""
    h = hashlib.sha256()
    for name, t in state_dict.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _flat(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def tiny_steps(cfg, variables, batches, mesh=None) -> dict:
    """`train_step` on each of `batches` from the JAX package's variables
    (seed 1): the losses, the gradient of micro-step 1 (this rank's, before
    any reduce) and the running statistics after it, the parameters and
    the state's digest after the last."""
    from peppa_tpu_torch.models.convert import (export_jax_variables,
                                                load_jax_variables)
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    model = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(model, variables)
    state = TrainState.create(model, cfg, mesh)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        state, m = train_step(state, batch, seed=1, device="cpu")
        out["losses"].append(m["train_loss"].item())
        if i == 0:
            out["grads"] = _flat(export_jax_variables(
                model, state.acc_grads)["params"])
            out["stats"] = _flat(export_jax_variables(model)["batch_stats"])
    out["params"] = _flat(export_jax_variables(model)["params"])
    out["digest"] = state_digest(model.state_dict())
    return out


def tp_steps(cfg, variables, batches, mesh=None, ckpt=None) -> dict:
    """`train_step` on each of `batches` from the JAX package's variables
    (seed 1), the model split over `mesh`'s model axis: the losses; after
    micro-step 1 the whole accumulation buffer (`state_dict()`'s: summed
    over the data rows, gathered over the model axis) and the running
    statistics; after the last the whole parameters, and with `ckpt` the
    parameters of a checkpoint written there, loaded into an unsplit
    model."""
    import torch

    from peppa_tpu_torch.models.convert import (export_jax_variables,
                                                load_jax_variables)
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.parallel.mesh import shard_model
    from peppa_tpu_torch.training.checkpoint import save_checkpoint
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step
    from peppa_tpu_torch.utils import dist

    model = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(model, variables)
    if mesh is not None:
        shard_model(model, mesh)
    state = TrainState.create(model, cfg, mesh)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        state, m = train_step(state, batch, seed=1, device="cpu")
        out["losses"].append(m["train_loss"].item())
        if i == 0:
            out["grads"] = _flat(export_jax_variables(
                model, state.state_dict()["acc_grads"])["params"])
            out["stats"] = _flat(export_jax_variables(model)["batch_stats"])
    whole = state.state_dict()["model"]
    params = {n: whole[n] for n, _ in model.named_parameters()}
    out["params"] = _flat(export_jax_variables(model, params)["params"])
    out["digest"] = state_digest(whole)
    if ckpt is not None:
        save_checkpoint(ckpt, state, {}, write=dist.is_main_process())
        if mesh is not None:
            torch.distributed.barrier()
        loaded = init_model(cfg, seed=1, device="cpu")
        loaded.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
        out["ckpt_params"] = _flat(export_jax_variables(loaded)["params"])
    return out


# ----------------------------------------------------------------- parallel
def job_parallel(inp: dict, mesh) -> dict:
    import torch

    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models.layers import BatchNorm
    from peppa_tpu_torch.ops.loss import triplet_loss
    from peppa_tpu_torch.parallel.contrastive import global_negative_loss
    from peppa_tpu_torch.parallel.mesh import (all_gather_rows,
                                               all_reduce_grads,
                                               global_moments, replicated,
                                               shard_batch, sync_batch_norm)
    from peppa_tpu_torch.training.step import step_generators
    from peppa_tpu_torch.utils.profiling import drain, recording

    out = {}
    # the loss both ways, with the gradients of this rank's rows
    routes = {
        "global_negative": lambda v, a: global_negative_loss(v, a, mesh),
        "gathered": lambda v, a: replicated(triplet_loss(
            all_gather_rows(v, mesh), all_gather_rows(a, mesh)), mesh)}
    for name, fn in routes.items():
        v = shard_batch(torch.from_numpy(inp["v"]), mesh).requires_grad_()
        a = shard_batch(torch.from_numpy(inp["a"]), mesh).requires_grad_()
        loss = fn(v, a)
        loss.backward()
        out[name] = (loss.item(), v.grad.numpy(), a.grad.numpy())

    # a synchronised BatchNorm: output, input and parameter gradients (this
    # rank's terms), running statistics
    bn = BatchNorm(inp["bn_x"].shape[1], torch.float32)
    sync_batch_norm(bn, mesh)
    x = shard_batch(torch.from_numpy(inp["bn_x"]), mesh).requires_grad_()
    y = bn(x, train=True)
    torch.sum(y * shard_batch(torch.from_numpy(inp["bn_r"]), mesh)).backward()
    out["bn"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                 "dweight": bn.weight.grad.numpy(),
                 "dbias": bn.bias.grad.numpy(),
                 "running_mean": bn.running_mean.numpy(),
                 "running_var": bn.running_var.numpy()}

    # the moments over more values a channel than float32 counts exactly
    out["big_moments"] = [m.numpy() for m in global_moments(
        torch.from_numpy(big_rows(mesh.rank)), (0,), mesh)]

    # the bucketed all-reduce, buckets smaller than some tensors
    tensors = [torch.full((n,), float(mesh.rank + 1) * (i + 1))
               for i, n in enumerate((3, 70, 5, 300))]
    all_reduce_grads(tensors, mesh, bucket_bytes=256)
    out["all_reduce"] = [t.numpy() for t in tensors]

    # two micro-steps of the tiny configuration (k = 2: one optimizer step),
    # with the names of each micro-step's phase spans
    cfg = Config.from_dict(tiny_raw(inp["data_dir"]))
    batches = [shard_batch(ClipBatch(**b), mesh) for b in global_batches()]
    drain()
    with recording():
        out.update(tiny_steps(cfg, inp["variables"], batches, mesh))
    spans = drain()
    roots = [s for s in spans if s["name"] == "train.step"]
    out["phases"] = [[s["name"] for s in spans if s["parent"] == r["id"]]
                     for r in roots]

    # micro-step 1 again under `tpu.global_negative_loss: false`
    cfg.tpu.global_negative_loss = False
    again = tiny_steps(cfg, inp["variables"], batches[:1], mesh)
    out["gathered_loss"] = again["losses"][0]
    out["gathered_grads"] = again["grads"]

    # the streams: layer-drop keeps alike on every rank, dropout masks not
    wave = torch.from_numpy(inp["wave"])
    for name, rates in (("keeps", dict(dropout=0.0, attention_dropout=0.0,
                                       activation_dropout=0.0,
                                       layer_drop=0.5)),
                        ("masks", dict(dropout=0.2, attention_dropout=0.2,
                                       activation_dropout=0.2,
                                       layer_drop=0.0))):
        w2v = small_wav2vec2(**rates)
        with torch.no_grad():
            runs = []
            for step in range(4):
                dropout, layerdrop = step_generators(
                    3, step, mesh.rank, torch.device("cpu"))
                runs.append(w2v(wave, deterministic=False, tap="context",
                                generator=dropout,
                                layerdrop_generator=layerdrop)[0].numpy())
            out[name] = runs
            out[name + "_deterministic"] = w2v(wave, tap="context")[0].numpy()
    return out


def job_one(inp: dict, mesh) -> dict:
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.types import ClipBatch

    return tiny_steps(Config.from_dict(tiny_raw(inp["data_dir"])),
                      inp["variables"],
                      [ClipBatch(**b) for b in global_batches()])


def job_remat(inp: dict, mesh) -> dict:
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models import dual_encoder
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.parallel.mesh import shard_batch
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    batches = [shard_batch(ClipBatch(**b), mesh) for b in global_batches()]
    real_checkpoint = dual_encoder.checkpoint
    out = {}
    for name, on in (("plain", False), ("remat", True)):
        cfg = Config.from_dict(remat_raw(inp["data_dir"]))
        cfg.tpu.remat_audio = cfg.tpu.remat_video = on
        model = init_model(cfg, seed=0, device="cpu")
        state = TrainState.create(model, cfg, mesh)
        handed, calls = [], [0]
        opt_step = state.optimizer.step

        def kept_step(*a, **kw):
            handed.append({n: p.grad.detach().numpy().copy()
                           for n, p in state.params.items()})
            return opt_step(*a, **kw)

        def counted(*a, **kw):
            calls[0] += 1
            return real_checkpoint(*a, **kw)

        state.optimizer.step = kept_step
        dual_encoder.checkpoint = counted
        try:
            losses = [train_step(state, b, seed=1, device="cpu")[1]
                      ["train_loss"].item() for b in batches]
        finally:
            dual_encoder.checkpoint = real_checkpoint
        out[name] = {"losses": losses, "handed": handed,
                     "digest": state_digest(model.state_dict()),
                     "checkpoints": calls[0], "micro_steps": len(batches)}
    return out


# ---------------------------------------------------------- tensor-parallel
def job_tp_train(inp: dict, mesh) -> dict:
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models import dual_encoder
    from peppa_tpu_torch.parallel.mesh import shard_batch

    with small_transformer(dual_encoder):
        batches = [shard_batch(ClipBatch(**b), mesh)
                   for b in global_batches()]
        return tp_steps(Config.from_dict(inp["raw"]), inp["variables"],
                        batches, mesh, os.path.join(inp["dir"], "tp.ckpt"))


def job_tp_one(inp: dict, mesh) -> dict:
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models import dual_encoder

    with small_transformer(dual_encoder):
        return tp_steps(Config.from_dict(inp["raw"]), inp["variables"],
                        [ClipBatch(**b) for b in global_batches()])


def _tp_model(raw: dict, variables, mesh=None, **tpu):
    """The configuration of `raw` (with `tpu`'s flags) and its model with
    the JAX package's variables, split over `mesh` (None: whole)."""
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.models.convert import load_jax_variables
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.parallel.mesh import shard_model

    cfg = Config.from_dict(raw)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    model = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(model, variables)
    if mesh is not None:
        shard_model(model, mesh)
    return cfg, model


def _both(rank: int, fn) -> dict:
    """{"mesh": fn(True)}, and on rank 0 also {"one": fn(False)}."""
    out = {"mesh": fn(True)}
    if rank == 0:
        out["one"] = fn(False)
    return out


def job_tp_pair(inp: dict, mesh) -> dict:
    import torch

    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models import dual_encoder
    from peppa_tpu_torch.parallel.mesh import (gather_model, replicate_tree,
                                               slice_model)
    from peppa_tpu_torch.training.optimization import BertAdam
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step

    raw, variables, out = inp["raw"], inp["variables"], {}
    waves = torch.from_numpy(inp["waves"])
    tree = {"a": [torch.full((3,), float(mesh.model_rank))],
            "b": (torch.arange(4.0) * (mesh.model_rank + 1),)}
    replicate_tree(tree, mesh)  # rank 0's tensors on both ranks
    out["replicated"] = [tree["a"][0].numpy(), tree["b"][0].numpy()]

    def encode(precision, quant=False):
        r = dict(raw, training={"trainer_args": {"precision": precision}})

        def run(split):
            _, model = _tp_model(r, variables, mesh if split else None,
                                 quantize_int8=quant)
            with torch.no_grad():
                return model.encode_audio(waves).float().numpy()
        return _both(mesh.model_rank, run)

    with small_transformer(dual_encoder):
        out["forward"] = {p: encode(p) for p in (32, 16)}
        out["int8"] = encode(32, quant=True)

        # a split parameter whose whole gradient's norm passes the clip
        # (max_grad_norm 1) while each slice's does not
        grad = torch.from_numpy(inp["clip_grad"])
        start = torch.linspace(-1.0, 1.0, grad.numel()).view(grad.shape)

        def clipped(split, groups=True):
            p = torch.nn.Parameter(slice_model(start, 0, mesh) if split
                                   else start.clone())
            p.grad = slice_model(grad, 0, mesh) if split else grad.clone()
            opt = BertAdam([p], lr=0.1, t_total=-1, weight_decay=0.0,
                           norm_groups={p: mesh.model_group}
                           if split and groups else None)
            opt.step()
            m = opt.state[p]["m"]  # 0.1 of the clipped gradient
            return [(gather_model(t, 0, mesh) if split else t).numpy()
                    for t in (p.data, m)]
        out["clip"] = _both(mesh.model_rank, clipped)
        out["clip"]["per_slice"] = clipped(True, groups=False)
        out["clip"]["slice_norm"] = float(slice_model(grad, 0, mesh).norm())

        # the default rates, and every rate at 0.1 (activation dropout on)
        batches = [ClipBatch(**b) for b in global_batches()]
        for name, rates in (("defaults", None), ("rates", 0.1)):
            r = dict(raw, audio=dict(raw["audio"], dropout=rates))

            def steps(split):
                cfg, model = _tp_model(r, variables,
                                       mesh if split else None)
                state = TrainState.create(model, cfg,
                                          mesh if split else None)
                names = [n for n, _ in model.named_parameters()]
                start = {n: t.numpy().copy()
                         for n, t in state.state_dict()["model"].items()
                         if n in names}
                losses = [train_step(state, b, seed=1, device="cpu")[1]
                          ["train_loss"].item() for b in batches]
                whole = state.state_dict()["model"]
                return {"losses": losses, "start": start,
                        "params": {n: whole[n].numpy() for n in names}}
            out[name] = _both(mesh.model_rank, steps)
    return out


def job_tp_serve(inp: dict, mesh) -> dict:
    import torch

    from peppa_tpu_torch.data.types import ClipBatch
    from peppa_tpu_torch.models import dual_encoder
    from peppa_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from peppa_tpu_torch.serving import EncoderService
    from peppa_tpu_torch.training.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    from peppa_tpu_torch.training.state import TrainState
    from peppa_tpu_torch.training.step import train_step
    from peppa_tpu_torch.utils import dist

    raw, variables, out = inp["raw"], inp["variables"], {}
    ckpt = os.path.join(inp["dir"], "tp12.ckpt")
    with small_transformer(dual_encoder):
        # on a (1, 2) mesh of the same ranks: 3 micro-steps (k = 2: inside
        # the second accumulation group), a checkpoint, micro-steps 4 and 5
        batches = [ClipBatch(**b) for b in global_batches(5)]
        pair = make_mesh((1, 2))
        cfg, model = _tp_model(raw, variables, pair)
        state = TrainState.create(model, cfg, pair)
        for b in batches[:3]:
            train_step(state, b, seed=1, device="cpu")
        save_checkpoint(ckpt, state, {"epoch": 0},
                        write=dist.is_main_process())
        out["next_losses"] = [train_step(state, b, seed=1, device="cpu")[1]
                              ["train_loss"].item() for b in batches[3:]]
        torch.distributed.barrier()  # rank 0's file is complete
        batches = batches[3:]

        # resumed on the (2, 1) mesh, and in one process on rank 0
        def resumed(split):
            cfg, model = _tp_model(raw, variables)
            state = TrainState.create(model, cfg, mesh if split else None)
            load_checkpoint(ckpt, state)
            return [train_step(state, shard_batch(b, mesh) if split else b,
                               seed=1, device="cpu")[1]["train_loss"].item()
                    for b in batches]
        out["resumed"] = _both(mesh.rank, resumed)

        def served(split):
            cfg, model = _tp_model(raw, variables)
            svc = EncoderService(model, cfg, batch_size=4, device="cpu",
                                 mesh=mesh if split else None)
            return {"audio": svc.embed_audio(inp["requests"]["audio"]),
                    "video": svc.embed_video(inp["requests"]["video"])}
        out["served"] = _both(mesh.rank, served)
    return out


# ---------------------------------------------------------------- multihost
def job_multihost(inp: dict, mesh) -> dict:
    import torch

    import peppa_tpu_torch.training.loop as L
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.data.datamodule import SyntheticPigData

    cfg = Config.from_dict(fit_raw(inp["data_dir"]))
    real_step = L.train_step
    out = {}

    def fit(tag, on_step=None, resume_from=None):
        """One fit into DIR/tag; `on_step(n)` runs after micro-step n."""
        calls = [0]
        handed = []  # the mean handed to BertAdam at each optimizer step

        def step(state, *args, **kwargs):
            if not handed:
                opt_step = state.optimizer.step

                def kept_step(*a, **kw):
                    handed.append({n: p.grad.detach().clone()
                                   for n, p in state.params.items()})
                    return opt_step(*a, **kw)

                state.optimizer.step = kept_step
                handed.append(None)  # wrapped
            result = real_step(state, *args, **kwargs)
            calls[0] += 1
            if on_step is not None:
                on_step(calls[0])
            return result

        L.train_step = step
        try:
            trainer = L.Trainer(cfg, log_dir=os.path.join(inp["dir"], tag),
                                device="cpu")
            state = trainer.fit(SyntheticPigData(cfg, n_train=FIT_TRAIN,
                                                 n_val=8),
                                resume_from=resume_from)
        finally:
            L.train_step = real_step
        out[tag] = {"step": state.step, "preempted": trainer.preempted,
                    "version_dir": trainer.version_dir,
                    "digest": state_digest(state.model.state_dict()),
                    "acc_grads": {n: t.clone()
                                  for n, t in state.acc_grads.items()},
                    "handed": handed[1:]}
        return trainer

    cfg.data.prepare = True  # refused over several ranks, before any write
    try:
        fit("prepare")
    except ValueError as e:
        out["prepare_refused"] = str(e)
    cfg.data.prepare = False
    fit("straight")

    # rank 1's clock jumps past max_time after its second micro-step
    class Clock:
        jump = 0.0

        @staticmethod
        def time():
            return time.time() + Clock.jump

    def late(n):
        if mesh.rank == 1 and n == 2:
            Clock.jump = 7200.0

    L.time = Clock
    try:
        fit("max_time", on_step=late)
    finally:
        L.time = time

    # rank 1 alone is signalled after its third micro-step (inside an
    # accumulation group: k = 2)
    def signal_rank1(n):
        if mesh.rank == 1 and n == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    fit("preempt", on_step=signal_rank1)
    ckpt = os.path.join(inp["dir"], "preempt", "version_0", "checkpoints",
                        "preempted.ckpt")
    torch.distributed.barrier()  # rank 0's file is complete
    fit("resume", resume_from=ckpt)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_inputs(inputs: dict, out_dir: str) -> None:
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)


def start_ranks(job: str, out_dir: str, world: int = 2):
    """Start `world` ranks of `job` on the inputs in `out_dir` (their
    output piped); `finish_ranks` collects them."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(port), out_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def finish_ranks(job: str, procs, out_dir: str,
                 timeout: float = 600) -> list:
    """Each rank's result, once every rank exited 0 (else the output of
    the ones that did not); kills them all past `timeout` seconds."""
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    failed = [f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(failed))
    results = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"{job}_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def main(argv) -> int:
    job, rank, world, port, out_dir = argv
    sys.path.insert(0, ROOT)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch

    torch.set_num_threads(2)
    from peppa_tpu_torch.parallel.mesh import make_mesh
    from peppa_tpu_torch.utils.dist import init_distributed

    group = int(world) > 1
    if group:
        init_distributed("cpu")
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh(MESHES.get(job)) if group else None
        out = {"parallel": job_parallel, "one": job_one,
               "multihost": job_multihost, "remat": job_remat,
               "tp_train": job_tp_train, "tp_one": job_tp_one,
               "tp_pair": job_tp_pair, "tp_serve": job_tp_serve}[job](inp,
                                                                     mesh)
        with open(os.path.join(out_dir, f"{job}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if group:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
