"""The port's 'model' axis (`parallel/mesh.py`: the 2-D process grid,
`param_shardings`, `shard_model`; the column- and row-parallel layers of
`models/wav2vec2.py`; BertAdam's clip of a split parameter; the state's
whole-tensor `state_dict`) against the JAX package's `_TP_RULES` and its
`make_train_step(mesh=...)` on a (2, 2) mesh of the virtual CPU devices
with `state_shardings`, and against the port in one process.

The (2, 2) side runs in four gloo processes (tests/torch_port_dist_worker.py,
job "tp_train"), the one-process side in a fifth ("tp_one"); the JAX side
runs here meanwhile.  The configuration is `tp_raw`'s: the tiny one with
two transformer layers of 4 heads and 64 FFN columns (`TP_AUDIO`), so 2
heads and 32 columns a rank; the JAX side takes its XLA attention route
under its Pallas-under-TP guard, the port its kernel route (the plain
versions on the CPU): the same function.

Tolerances (tests/test_torch_port_parallel.py's, and why they hold here):
the row-parallel products sum two float32 partial sums where one process
sums one, a rounding-level change (about 1e-7 relative) like the data
axis's gathered rows; so the losses within rel 2e-4 of the JAX package's
(its train-step case) and 1e-5 of one process, the gradient of micro-step
1 (summed over the data rows, gathered over 'model') with the audio
tower's within 1e-3 of each tensor's largest entry and the video tower's
by norm within 10% (R(2+1)D-style towers in training mode are chaotic in
float32), the running statistics atol 1e-5, the parameters after the
optimizer step within 1e-3 of each tensor's largest entry plus 1e-3 lr
and the video tower's update by norm within 10% plus 1e-3 lr (the
attention pools' biases start at 0 with gradients at rounding level,
1e-10, where BertAdam's update is in its epsilon-bound regime,
proportional to the gradient).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.models import dual_encoder as jax_dual_encoder
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from peppa_tpu.parallel.mesh import param_shardings as jax_param_shardings
from peppa_tpu.parallel.mesh import shard_batch as jax_shard_batch
from peppa_tpu.parallel.mesh import state_shardings as jax_state_shardings
from peppa_tpu.training.optimization import make_optimizer as jax_make_opt
from peppa_tpu.training.state import TrainState as JaxTrainState
from peppa_tpu.training.step import make_train_step
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models import dual_encoder
from peppa_tpu_torch.models.convert import _jax_path, load_jax_variables
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.parallel.mesh import Mesh, param_shardings, shard_model

LR = Config().optimizer.lr


def _jax_flat(tree):
    return W._flat(jax.tree.map(np.asarray, tree))


def _jax_side(cfg, model, variables) -> dict:
    """Two micro-steps of `make_train_step(mesh=...)` on a (2, 2) mesh,
    the state on `state_shardings`, and `param_shardings`' specs."""
    mesh = jax_make_mesh((2, 2), ("data", "model"))
    specs = jax.tree_util.tree_flatten_with_path(
        jax_param_shardings(variables["params"], mesh))[0]
    out = {"specs": {tuple(str(getattr(k, "key", k)) for k in path): s.spec
                     for path, s in specs}}
    tx = jax_make_opt(cfg.optimizer, accumulate_grad_batches=2,
                      params=variables["params"])
    state = JaxTrainState.create(variables, tx)
    with mesh:
        state = jax.tree.map(lambda x, s: jax.device_put(x, s), state,
                             jax_state_shardings(state, mesh))
        step = make_train_step(model, cfg.margin, donate=False, mesh=mesh)
        out["losses"] = []
        for i, b in enumerate(W.global_batches()):
            state, m = step(state, jax_shard_batch(JaxClipBatch(**b), mesh),
                            jax.random.PRNGKey(1))
            out["losses"].append(float(m["train_loss"]))
            if i == 0:
                out["grads"] = _jax_flat(state.opt_state.acc_grads)
                out["stats"] = _jax_flat(state.batch_stats)
        out["params"] = _jax_flat(state.params)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("tensor_parallel")
    raw = W.tp_raw(str(d / "data"))
    jax_cfg, cfg = JaxConfig.from_dict(raw), Config.from_dict(raw)
    assert cfg.to_dict() == jax_cfg.to_dict()
    with W.small_transformer(jax_dual_encoder):
        jax_model, variables = jax_init_model(
            jax_cfg, jax.random.PRNGKey(0), audio_samples=W.SAMPLES,
            video_frames=W.FRAMES)
        variables = jax.tree.map(np.asarray, variables)
        W.write_inputs({"raw": raw, "variables": variables, "dir": str(d)},
                       str(d))
        ranks = W.start_ranks("tp_train", str(d), world=4)
        one = W.start_ranks("tp_one", str(d), world=1)
        try:
            jax_out = _jax_side(jax_cfg, jax_model, variables)
        finally:
            one = W.finish_ranks("tp_one", one, str(d))[0]
            ranks = W.finish_ranks("tp_train", ranks, str(d))
    with W.small_transformer(dual_encoder):
        model = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(model, variables)
    return {"jax": jax_out, "one": one, "ranks": ranks, "model": model,
            "variables": W._flat(variables["params"])}


def _hold_grads(got, want, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k.startswith("video_encoder/"):
            assert np.linalg.norm(g - w) <= 0.1 * np.linalg.norm(w) + 1e-8, \
                (what, k)
        else:
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() + 1e-8, \
                (what, k)


def _hold_params(got, want, start, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k.startswith("video_encoder/"):
            assert (np.linalg.norm(g - w)
                    <= 0.1 * np.linalg.norm(w - start[k]) + 1e-3 * LR), \
                (what, k)
        else:
            assert (np.abs(g - w).max()
                    <= 1e-3 * np.abs(w).max() + 1e-3 * LR), (what, k)


def test_param_shardings_split_what_the_jax_rules_split(run):
    """Every parameter: the port's split dimension is the JAX spec's on the
    port's (out, in) layout (tests/test_parallel.py::
    test_tp_param_shardings_applied's cases among them)."""
    model = run["model"]
    split = param_shardings(model, Mesh((2, 2), ("data", "model")))
    jax_dim = {P(): None, P(None, "model"): 0, P("model", None): 1,
               P("model"): 0}
    for name, dim in split.items():
        _, path = _jax_path(model, name)
        assert dim == jax_dim[run["jax"]["specs"][path]], name
    layer = "audio_encoder.wav2vec2.layer0."
    assert split[layer + "ffn_in.weight"] == 0  # on its outputs
    assert split[layer + "attention.out_proj.weight"] == 1  # on its inputs
    assert split[layer + "attention.out_proj.bias"] is None
    assert all(dim is None for name, dim in split.items()
               if "feature_extractor" in name)
    assert sum(dim is not None for dim in split.values()) == 2 * 10
    assert all(dim is None for dim in param_shardings(
        model, Mesh((4, 1), ("data", "model"))).values())
    assert all(dim is None for dim in param_shardings(
        model, Mesh((2, 2), ("data", "model")),
        tensor_parallel=False).values())


def test_shard_model_refuses_a_model_axis_that_does_not_divide_the_heads(
        run):
    with pytest.raises(ValueError, match="does not divide 4 attention heads"):
        shard_model(run["model"], Mesh((1, 3), ("data", "model")))
    assert run["model"].audio_encoder.wav2vec2.layer0.attention.heads == 4


def test_train_step_on_a_2x2_mesh_matches_jax(run):
    """The JAX package's step on a (2, 2) mesh doubles the gradient of the
    positional conv's weight-normed kernel (`pos_conv_g`, `pos_conv_v`),
    which no rule splits; its steps on (1, 1) and (2, 1) meshes do not,
    and the port's (2, 2) gradient equals one process's (the next test).
    So the port's is held to half of it (ROADMAP parity traps)."""
    ranks, jax_out = run["ranks"], run["jax"]
    for r in ranks[1:]:  # the same losses and state on every rank
        assert r["losses"] == ranks[0]["losses"]
        assert r["digest"] == ranks[0]["digest"]
    np.testing.assert_allclose(ranks[0]["losses"], jax_out["losses"],
                               rtol=2e-4)
    want = {k: w / 2 if k.endswith(("/pos_conv_g", "/pos_conv_v")) else w
            for k, w in jax_out["grads"].items()}
    _hold_grads(ranks[0]["grads"], want, "gradients")
    for k, want in jax_out["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][k], want, rtol=0,
                                   atol=1e-5, err_msg=k)
    _hold_params(ranks[0]["params"], jax_out["params"], run["variables"],
                 "parameters")


def test_train_step_on_a_2x2_mesh_matches_one_process(run):
    """...and the checkpoint it wrote loads into an unsplit model with the
    whole parameters."""
    r0, one = run["ranks"][0], run["one"]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    _hold_grads(r0["grads"], one["grads"], "gradients")
    for k, want in one["stats"].items():
        np.testing.assert_allclose(r0["stats"][k], want, rtol=0, atol=1e-5,
                                   err_msg=k)
    _hold_params(r0["params"], one["params"], run["variables"], "parameters")
    _hold_params(r0["ckpt_params"], one["params"], run["variables"],
                 "checkpoint")
    for k, want in r0["params"].items():
        np.testing.assert_array_equal(r0["ckpt_params"][k], want, err_msg=k)
