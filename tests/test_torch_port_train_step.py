"""The port's train step against the JAX package's `make_train_step`, on
the CPU.

The configuration of tests/test_torch_port_slice.py (wav2vec2-base with 2
of its 12 layers, R(2+1)D-18, float32, 32x32 video, 16 kHz audio) with
`audio.dropout: 0.0` (every stochastic rate 0: a deterministic training
forward), `accumulate_grad_batches: 2` and a constant learning rate
(`t_total: -1`; under `warmup_linear` the first optimizer step has lr 0 and
nothing would move).  The JAX variables are carried across; both packages
then take the same 4 micro-steps (2 optimizer steps) on the same batches.

Tolerances, and why:
- micro-steps 1-2 run on the same weights: losses at rtol 1e-5, running
  statistics at 1e-5;
- R(2+1)D-18 in training mode at this size is chaotic in float32 (batch
  statistics over 16 elements per channel in layer4): a 1e-7 relative
  perturbation of its weights moves the port's own video gradients by a
  median 2.5% (up to 22%) of each tensor's largest entry.  So the video
  tower's first-step gradients are held by norm (10% of the tensor's
  norm), and the audio tower's, which see the video embeddings through the
  loss, within 1e-3 of each tensor's largest entry (plus 1e-8 for the
  tensors whose exact gradient is 0: the k_proj biases and the attention
  pool's output bias, where both packages return rounding noise);
- Adam's first update is about lr * 3.2 * sign(g), so gradients near 0
  flip sign between the two packages: after two optimizer steps
  parameters agree within 15 lr (two flips at most) and 99% of them within
  2 lr, at lr 1e-6; the losses of micro-steps 3-4 at rtol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.training.optimization import make_optimizer as jax_make_opt
from peppa_tpu.training.state import TrainState as JaxTrainState
from peppa_tpu.training.step import make_train_step
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models.convert import (export_jax_variables,
                                            load_jax_variables)
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.training.step import train_step

LR = 1e-6
RAW = {
    "data": {"target_size": [32, 32], "audio_sample_rate": 16000},
    "audio": {"num_layers": 2, "dropout": 0.0},
    "training": {"trainer_args": {"precision": 32,
                                  "accumulate_grad_batches": 2}},
    "optimizer": {"t_total": -1, "lr": LR},
    "tpu": {"bucket_durations": [0.1, 0.2]},
}


def _batches(b=4, n=2):
    rng = np.random.default_rng(0)
    return [dict(
        video=rng.integers(0, 256, size=(b, 8, 32, 32, 3)).astype(np.uint8),
        audio=rng.normal(scale=0.1, size=(b, 3200)).astype(np.float32),
        video_frames=np.array([8, 5, 8, 3], np.int32),
        audio_samples=np.array([3200, 2000, 3100, 1200], np.int32),
        video_duration=np.full((b,), 0.2, np.float32),
        audio_duration=np.full((b,), 0.2, np.float32)) for _ in range(n)]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs():
    jax_cfg, cfg = JaxConfig.from_dict(RAW), Config.from_dict(RAW)
    assert cfg.to_dict() == jax_cfg.to_dict()
    jax_model, variables = jax_init_model(jax_cfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    port = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(port, variables)
    exported = export_jax_variables(port)

    tx = jax_make_opt(jax_cfg.optimizer, accumulate_grad_batches=2,
                      params=variables["params"])
    jstate = JaxTrainState.create(variables, tx)
    step = make_train_step(jax_model, jax_cfg.margin, donate=False)
    state = TrainState.create(port, cfg)
    out = {"variables": variables, "exported": exported, "jax": [],
           "port": []}
    for i, b in enumerate(_batches() * 2):
        jstate, jm = step(jstate, JaxClipBatch(**b), jax.random.PRNGKey(1))
        state, m = train_step(state, ClipBatch(**b), seed=1, device="cpu")
        out["jax"].append(float(jm["train_loss"]))
        out["port"].append(float(m["train_loss"]))
        if i == 0:  # the accumulation buffer holds micro-step 1's gradient
            out["jax_grads"] = _flat(jstate.opt_state.acc_grads)
            out["port_grads"] = _flat(export_jax_variables(
                port, state.acc_grads)["params"])
        if i == 1:  # running statistics before any parameter moved
            out["jax_stats"] = _flat(jstate.batch_stats)
            out["port_stats"] = _flat(export_jax_variables(port)
                                      ["batch_stats"])
    out["jax_params"] = _flat(jstate.params)
    out["port_params"] = _flat(export_jax_variables(port)["params"])
    out["state"] = state
    return out


def test_export_round_trip(runs):
    want, got = _flat(runs["variables"]), _flat(runs["exported"])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    fresh = init_model(Config.from_dict(RAW), seed=1, device="cpu")
    load_jax_variables(fresh, runs["exported"])
    again = _flat(export_jax_variables(fresh))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k])


def test_losses_match_jax(runs):
    np.testing.assert_allclose(runs["port"][:2], runs["jax"][:2], rtol=1e-5)
    np.testing.assert_allclose(runs["port"][2:], runs["jax"][2:], rtol=1e-3)
    assert runs["state"].step == 4
    assert runs["state"].optimizer.param_groups[0]["step"] == 2


def test_first_micro_step_gradients_match_jax(runs):
    want, got = runs["jax_grads"], runs["port_grads"]
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if k.startswith("['video_encoder']"):
            assert (np.linalg.norm(g - w)
                    <= 0.1 * np.linalg.norm(w) + 1e-8), k
        else:
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() + 1e-8, k


def test_batch_stats_match_jax(runs):
    want, got = runs["jax_stats"], runs["port_stats"]
    assert want.keys() == got.keys() and len(want) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_params_after_two_optimizer_steps(runs):
    want, got = runs["jax_params"], runs["port_params"]
    start = _flat(runs["variables"]["params"])
    d = np.concatenate([np.abs(got[k] - w).ravel() for k, w in want.items()])
    moved = max(np.abs(w - start[k]).max() for k, w in want.items())
    assert moved > 2 * LR  # the optimizer did move them
    assert d.max() <= 15 * LR
    assert np.quantile(d, 0.99) <= 2 * LR


def test_train_step_is_seeded():
    """The default rates (dropout 0.1, layer-drop 0.05): a seed gives the
    same step, another seed another."""
    raw = {k: v for k, v in RAW.items() if k != "audio"}
    raw["audio"] = {"num_layers": 2}
    cfg = Config.from_dict(raw)
    batch = ClipBatch(**_batches(n=1)[0])
    losses, params = [], []
    for seed in (1, 1, 2):
        model = init_model(cfg, seed=0, device="cpu")
        state, m = train_step(TrainState.create(model, cfg), batch, seed,
                              device="cpu")
        losses.append(float(m["train_loss"]))
        params.append(state.acc_grads["audio_encoder.project.weight"])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert torch.equal(params[0], params[1])
    assert not torch.equal(params[0], params[2])
