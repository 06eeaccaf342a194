"""The port's data-parallel training (`utils/dist.py`, `parallel/mesh.py`,
`parallel/contrastive.py`, the synchronised BatchNorm, `train_step` over a
mesh) at W = 2 against the JAX package on a (2, 1) mesh of the virtual CPU
devices (tests/test_parallel.py's cases), and against the port at W = 1 on
the concatenated batch.

The W = 2 side runs in two gloo processes (tests/torch_port_dist_worker.py,
job "parallel"), started once for the module, and the port at W = 1 in a
third (job "one"); the JAX side runs here meanwhile.  The inputs are made
with numpy from a seed and the JAX package's weights are carried across
(`load_jax_variables`).

Tolerances, and why:
- the losses: rel 1e-5 (tests/test_parallel.py's) for the loss alone, rel
  2e-4 for the train step (its train-step case);
- the loss's gradients: atol 1e-6 (tests/test_parallel.py's);
- the train step's gradient of micro-step 1 (summed over the ranks, as
  the optimizer step's all-reduce sums it): the audio tower's within 1e-3
  of each tensor's largest entry, the video tower's by norm within 10%
  (R(2+1)D-style towers in training mode are chaotic in float32:
  tests/test_torch_port_train_step.py); the running statistics atol 1e-5;
- the parameters after the optimizer step: the audio tower's within 1e-3
  of each tensor's largest entry plus 1e-3 lr (the attention pool's
  biases start at 0 with gradients near rounding level, where BertAdam's
  update is in its epsilon-bound regime, proportional to the gradient:
  1e-3 of the gradient is 1e-3 of the parameter there), the video tower's
  by norm within 10% of the update's norm;
- W = 2 against W = 1 in the port: the same, and the gathered-rows route
  equals `triplet_loss` on the concatenated rows bit for bit (each rank
  takes half of the replicated loss's gradient and the gather's backward
  adds the halves).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.parallel.contrastive import (global_negative_loss as
                                            jax_global_negative_loss)
from peppa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from peppa_tpu.parallel.mesh import shard_batch as jax_shard_batch
from peppa_tpu.training.optimization import make_optimizer as jax_make_opt
from peppa_tpu.training.state import TrainState as JaxTrainState
from peppa_tpu.training.step import make_train_step
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models.layers import BatchNorm
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.parallel.mesh import (Mesh, make_mesh, shard_batch,
                                           shard_model)

B_LOSS, D_LOSS = 16, 32
LR = Config().optimizer.lr  # the tiny configuration's


def _jax_flat(tree):
    return W._flat(jax.tree.map(np.asarray, tree))


def _jax_side(cfg, model, variables, inputs) -> dict:
    """The JAX package on a (2, 1) mesh: the global-negative loss and its
    gradients, then two micro-steps of `make_train_step(mesh=...)`."""
    mesh = jax_make_mesh((2, 1), ("data", "model"))
    sharding = NamedSharding(mesh, P("data", None))
    v = jax.device_put(inputs["v"], sharding)
    a = jax.device_put(inputs["a"], sharding)
    with mesh:
        fn = lambda v, a: jax_global_negative_loss(v, a, mesh, margin=0.2)
        out = {"loss": float(jax.jit(fn)(v, a)),
               "loss_grads": [np.asarray(g) for g in jax.jit(jax.grad(
                   fn, argnums=(0, 1)))(v, a)]}
        tx = jax_make_opt(cfg.optimizer, accumulate_grad_batches=2,
                          params=variables["params"])
        state = JaxTrainState.create(variables, tx)
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
    d = tmp_path_factory.mktemp("parallel")
    raw = W.tiny_raw(str(d / "data"))
    jax_cfg, cfg = JaxConfig.from_dict(raw), Config.from_dict(raw)
    assert cfg.to_dict() == jax_cfg.to_dict()
    jax_model, variables = jax_init_model(
        jax_cfg, jax.random.PRNGKey(0), audio_samples=W.SAMPLES,
        video_frames=W.FRAMES)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(0)
    inputs = {
        "v": rng.normal(size=(B_LOSS, D_LOSS)).astype(np.float32),
        "a": rng.normal(size=(B_LOSS, D_LOSS)).astype(np.float32),
        "bn_x": rng.normal(loc=0.5, size=(8, 3, 2, 4, 4)).astype(np.float32),
        "bn_r": rng.normal(size=(8, 3, 2, 4, 4)).astype(np.float32),
        "wave": rng.normal(scale=0.1, size=(2, 1600)).astype(np.float32),
        "variables": variables, "data_dir": raw["data"]["data_dir"]}
    W.write_inputs(inputs, str(d))
    ranks = W.start_ranks("parallel", str(d))
    one = W.start_ranks("one", str(d), world=1)
    try:
        jax_out = _jax_side(jax_cfg, jax_model, variables, inputs)
    finally:
        one = W.finish_ranks("one", one, str(d))[0]
        ranks = W.finish_ranks("parallel", ranks, str(d))
    return {"inputs": inputs, "jax": jax_out, "one": one, "ranks": ranks,
            "variables": W._flat(variables["params"])}


def _cat(ranks, key, i):
    return np.concatenate([r[key][i] for r in ranks])


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
    for k, w in want.items():
        g = got[k]
        if k.startswith("video_encoder/"):
            assert (np.linalg.norm(g - w)
                    <= 0.1 * np.linalg.norm(w - start[k]) + 1e-8), (what, k)
        else:
            assert (np.abs(g - w).max()
                    <= 1e-3 * np.abs(w).max() + 1e-3 * LR), (what, k)


def test_global_negative_loss_matches_jax_on_a_2x1_mesh(run):
    ranks, jax_out = run["ranks"], run["jax"]
    loss = [r["global_negative"][0] for r in ranks]
    assert loss[0] == loss[1]  # the all-reduced total, alike on each rank
    assert loss[0] == pytest.approx(jax_out["loss"], rel=1e-5)
    for i, want in zip((1, 2), jax_out["loss_grads"]):
        np.testing.assert_allclose(_cat(ranks, "global_negative", i), want,
                                   rtol=0, atol=1e-6)


def test_global_negative_loss_matches_triplet_loss_on_the_gathered_rows(run):
    ranks, inputs = run["ranks"], run["inputs"]
    v = torch.from_numpy(inputs["v"]).requires_grad_()
    a = torch.from_numpy(inputs["a"]).requires_grad_()
    want = triplet_loss(v, a)
    want.backward()
    assert ranks[0]["global_negative"][0] == pytest.approx(want.item(),
                                                           rel=1e-5)
    np.testing.assert_allclose(_cat(ranks, "global_negative", 1),
                               v.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_cat(ranks, "global_negative", 2),
                               a.grad.numpy(), rtol=0, atol=1e-6)
    # the gathered-rows route is triplet_loss itself, bit for bit
    for r in ranks:
        assert r["gathered"][0] == want.item()
    np.testing.assert_array_equal(_cat(ranks, "gathered", 1), v.grad.numpy())
    np.testing.assert_array_equal(_cat(ranks, "gathered", 2), a.grad.numpy())


def test_synchronised_batch_norm_matches_one_process(run):
    ranks, inputs = run["ranks"], run["inputs"]
    bn = BatchNorm(3, torch.float32)
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_()
    y = bn(x, train=True)
    torch.sum(y * torch.from_numpy(inputs["bn_r"])).backward()
    got = [r["bn"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               y.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]),
                               x.grad.numpy(), rtol=1e-5, atol=1e-5)
    for name, want in (("dweight", bn.weight.grad), ("dbias", bn.bias.grad)):
        np.testing.assert_allclose(got[0][name] + got[1][name],
                                   want.numpy(), rtol=1e-5, atol=1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(got[0][name], got[1][name])
        np.testing.assert_allclose(got[0][name], getattr(bn, name).numpy(),
                                   rtol=0, atol=1e-6)


def test_global_moments_count_past_float32s_exact_integers(run):
    """2 x (2^23 + 1) values in one channel: E[x] and E[x^2] of both ranks'
    rows, against float64 (float32 sums of 8.4M values: rel 1e-5)."""
    ranks = run["ranks"]
    x = np.concatenate([W.big_rows(r) for r in range(2)]).astype(np.float64)
    assert x.size > 1 << 24
    for r in ranks:
        mean, mean_sq = r["big_moments"]
        np.testing.assert_allclose(mean, x.mean(0), rtol=1e-5)
        np.testing.assert_allclose(mean_sq, (x * x).mean(0), rtol=1e-5)
    np.testing.assert_array_equal(ranks[0]["big_moments"][0],
                                  ranks[1]["big_moments"][0])


def test_gradient_all_reduce_sums_in_buckets(run):
    for r in run["ranks"]:
        for i, t in enumerate(r["all_reduce"]):
            np.testing.assert_array_equal(t, np.full(t.shape, 3.0 * (i + 1),
                                                     np.float32))


def _summed_grads(ranks):
    return {k: ranks[0]["grads"][k] + ranks[1]["grads"][k]
            for k in ranks[0]["grads"]}


def test_train_step_matches_jax_on_a_2x1_mesh(run):
    ranks, jax_out = run["ranks"], run["jax"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], jax_out["losses"],
                               rtol=2e-4)
    _hold_grads(_summed_grads(ranks), jax_out["grads"], "gradients")
    for r in ranks:
        assert r["stats"].keys() == jax_out["stats"].keys()
        for k, want in jax_out["stats"].items():
            np.testing.assert_allclose(r["stats"][k], want, rtol=0,
                                       atol=1e-5, err_msg=k)
    assert ranks[0]["digest"] == ranks[1]["digest"]  # the same step
    _hold_params(ranks[0]["params"], jax_out["params"], run["variables"],
                 "parameters")


def test_train_step_at_two_ranks_matches_one_rank(run):
    ranks, one = run["ranks"], run["one"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    _hold_grads(_summed_grads(ranks), one["grads"], "gradients")
    for k, want in one["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][k], want, rtol=0,
                                   atol=1e-5, err_msg=k)
    _hold_params(ranks[0]["params"], one["params"], run["variables"],
                 "parameters")


def test_train_step_spans_on_a_2x1_mesh(run):
    """Each rank's micro-steps are its phase spans; the optimizer step's
    gradient all-reduce is `train.all_reduce`, before `train.optimizer`."""
    for r in run["ranks"]:
        phases = ["train.forward", "train.loss", "train.backward",
                  "train.accumulate"]
        assert r["phases"] == [phases,
                               phases + ["train.all_reduce",
                                         "train.optimizer"]]


def test_global_negative_loss_flag_selects_the_gathered_route(run):
    """`tpu.global_negative_loss: false` takes `triplet_loss` on the
    gathered rows: the same loss and gradient to rounding."""
    ranks = run["ranks"]
    for r in ranks:
        assert r["gathered_loss"] == pytest.approx(r["losses"][0], rel=1e-6)
    summed = {k: ranks[0]["gathered_grads"][k] + ranks[1]["gathered_grads"][k]
              for k in ranks[0]["gathered_grads"]}
    want = _summed_grads(ranks)
    for k, w in want.items():
        assert np.abs(summed[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-9, k


def test_layer_drop_keeps_agree_and_dropout_masks_differ(run):
    r0, r1 = run["ranks"]
    for a, b in zip(r0["keeps"], r1["keeps"]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, r0["keeps_deterministic"])
               for a in r0["keeps"])  # some layer was dropped
    for a, b in zip(r0["masks"], r1["masks"]):
        assert not np.allclose(a, b)


def test_make_mesh_checks_the_process_group():
    mesh = make_mesh()
    assert (mesh.shape, mesh.data, mesh.rank, mesh.group) == ((1, 1), 1, 0,
                                                              None)
    assert make_mesh((1, 1)).data == 1
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh((2, 1))
    with pytest.raises(ValueError, match="puts 2 ranks on the mesh; the "
                       "process group has 1"):
        make_mesh((1, 2))
    with pytest.raises(ValueError, match="'data' axis"):
        make_mesh((1,), ("model",))
    model = W.small_wav2vec2()
    box = torch.nn.ModuleDict({"wav2vec2": model})
    with pytest.raises(ValueError, match="does not divide 4 attention heads"):
        shard_model(box, Mesh((1, 3), ("data", "model")))


def test_shard_batch_takes_this_ranks_rows():
    b = ClipBatch(**W.global_batches(1)[0])
    mesh = Mesh((2, 1), ("data", "model"), rank=1)
    got = shard_batch(b, mesh)
    np.testing.assert_array_equal(got.audio, b.audio[4:])
    np.testing.assert_array_equal(got.video_frames, b.video_frames[4:])
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(b.audio[:3], mesh)


def test_init_distributed_raises_without_cuda(monkeypatch):
    from peppa_tpu_torch.utils import dist

    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.init_distributed()
    assert not torch.distributed.is_initialized()
    assert (dist.process_index(), dist.process_count(),
            dist.is_main_process()) == (0, 1, True)
