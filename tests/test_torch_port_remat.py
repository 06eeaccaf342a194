"""`tpu.remat_audio` / `tpu.remat_video` in the port
(`models/dual_encoder.py`: `torch.utils.checkpoint` of the towers) on the
CPU.

- Against the JAX package's `nn.remat` (tests/test_models.py::
  test_remat_matches_plain_forward's configuration: 32x32, r3d_18, the
  conv-only audio trunk, float32), the JAX variables carried across: the
  forward and the gradients of `triplet_loss` through the rematted towers
  within 1e-5 (the JAX test's tolerance).
- The port with remat on against off, `torch.equal` throughout: four
  micro-steps of `train_step` (k = 2: two optimizer steps) with dropout
  and layer-drop at 0.1, where the recompute must draw the first run's
  masks from the step's generators and BatchNorm must move its running
  statistics once; the static tower; the caller's generators; two gloo
  ranks with synchronised BatchNorm (tests/torch_port_dist_worker.py,
  job "remat").
- Calls that record no graph (`eval_step`, `EncoderService`, an exported
  program's tracing) do not go through the checkpoint at all.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.ops.loss import triplet_loss as jax_triplet_loss
from peppa_tpu_torch import export
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models import dual_encoder
from peppa_tpu_torch.models.convert import (export_jax_variables,
                                            load_jax_variables)
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.ops.loss import triplet_loss
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.training.step import eval_step, train_step

TOL = 1e-5  # tests/test_models.py::test_remat_matches_plain_forward's

# the JAX test's configuration
JAX_RAW = {"data": {"target_size": [32, 32]},
           "audio": {"full": False}, "video": {"version": "r3d_18"},
           "training": {"trainer_args": {"precision": 32}}}
# a training configuration with every stochastic rate at 0.1: a 2-layer
# wav2vec2 (dropout and layer-drop), R(2+1)D-18 (BatchNorm), k = 2 and a
# constant learning rate, so that both optimizer steps move the weights
TRAIN_RAW = {"data": {"target_size": [32, 32], "audio_sample_rate": 1600},
             "audio": {"num_layers": 2, "dropout": 0.1},
             "training": {"trainer_args": {"precision": 32,
                                           "accumulate_grad_batches": 2}},
             "optimizer": {"t_total": -1},
             "tpu": {"bucket_durations": [0.8, 2.0]}}


def _with_remat(raw: dict, on: bool = True) -> dict:
    raw = copy.deepcopy(raw)
    raw.setdefault("tpu", {}).update(remat_audio=on, remat_video=on)
    return raw


def _batch(rng, b=2, frames=4, samples=3200) -> dict:
    return dict(
        video=rng.integers(0, 256, size=(b, frames, 32, 32, 3))
        .astype(np.uint8),
        audio=rng.normal(scale=0.1, size=(b, samples)).astype(np.float32),
        video_frames=rng.integers(frames // 2, frames + 1, size=b)
        .astype(np.int32),
        audio_samples=np.full((b,), samples, np.int32),
        video_duration=np.ones((b,), np.float32),
        audio_duration=np.ones((b,), np.float32))


class _Checkpoints:
    """Counts the calls of `torch.utils.checkpoint.checkpoint` the towers
    make."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = dual_encoder.checkpoint

        def counted(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(dual_encoder, "checkpoint", counted)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    torch.set_num_threads(2)


@pytest.fixture
def checkpoints(monkeypatch):
    return _Checkpoints(monkeypatch)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package with both remat flags on the JAX test's
    configuration: variables, a batch, the embeddings and the gradients of
    `triplet_loss` (eval-mode towers, as in the JAX test)."""
    cfg = JaxConfig.from_dict(_with_remat(JAX_RAW))
    assert cfg.tpu.remat_audio and cfg.tpu.remat_video
    model, variables = jax_init_model(cfg, jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0))
    jbatch = JaxClipBatch(**{k: jnp.asarray(v) for k, v in batch.items()})

    def loss_fn(params):
        o = model.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        jbatch, train=False)
        return jax_triplet_loss(o.video, o.audio), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return {"variables": jax.tree.map(np.asarray, variables),
            "batch": batch, "video": np.asarray(out.video),
            "audio": np.asarray(out.audio),
            "grads": W._flat(jax.tree.map(np.asarray, grads))}


def test_the_rematted_jax_tree_loads_into_the_port_unchanged(jax_run):
    """`nn.remat` leaves the JAX variables' tree as it is: the names and
    shapes of the port's own tree (the plain JAX module's, as
    tests/test_torch_port_convert.py holds), which `load_jax_variables`
    takes and gives back unchanged."""
    got = jax_run["variables"]
    model = init_model(Config.from_dict(_with_remat(JAX_RAW)), device="cpu")
    own = export_jax_variables(model)
    for part in ("params", "batch_stats"):
        assert ({k: v.shape for k, v in W._flat(got[part]).items()}
                == {k: v.shape for k, v in W._flat(own[part]).items()})
    load_jax_variables(model, got)
    back = export_jax_variables(model)
    for part in ("params", "batch_stats"):
        for k, v in W._flat(got[part]).items():
            np.testing.assert_array_equal(W._flat(back[part])[k], v)


def test_rematted_port_matches_the_rematted_jax_package(jax_run,
                                                        checkpoints):
    model = init_model(Config.from_dict(_with_remat(JAX_RAW)), device="cpu")
    load_jax_variables(model, jax_run["variables"])
    batch = ClipBatch(**{k: torch.from_numpy(v)
                         for k, v in jax_run["batch"].items()})
    out = model(batch, train=False)
    assert checkpoints.calls == 2  # both towers, through the checkpoint
    np.testing.assert_allclose(out.video.detach().numpy(), jax_run["video"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.audio.detach().numpy(), jax_run["audio"],
                               rtol=TOL, atol=TOL)
    triplet_loss(out.video, out.audio).backward()
    grads = W._flat(export_jax_variables(model, {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None})["params"])
    assert grads.keys() == jax_run["grads"].keys()
    for k, want in jax_run["grads"].items():
        np.testing.assert_allclose(grads[k], want, rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert any(np.abs(g).max() > 0 for g in grads.values())


def _train(raw: dict, batches, seed: int = 1) -> dict:
    """`train_step` on each batch: the losses, the means handed to
    BertAdam at each optimizer step, and the final state dict."""
    cfg = Config.from_dict(raw)
    model = init_model(cfg, seed=0, device="cpu")
    state = TrainState.create(model, cfg)
    handed = []
    opt_step = state.optimizer.step

    def kept_step(*a, **kw):
        handed.append({n: p.grad.detach().clone()
                       for n, p in state.params.items()})
        return opt_step(*a, **kw)

    state.optimizer.step = kept_step
    losses = []
    for b in batches:
        state, m = train_step(state, ClipBatch(**b), seed=seed,
                              device="cpu")
        losses.append(m["train_loss"])
    return {"losses": losses, "handed": handed,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _assert_equal_runs(got: dict, want: dict) -> None:
    assert len(got["handed"]) == len(want["handed"]) == 2
    for g, w in zip(got["losses"], want["losses"]):
        assert torch.equal(g, w)
    for g, w in zip(got["handed"], want["handed"]):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert got["state"].keys() == want["state"].keys()
    for k, w in want["state"].items():
        assert torch.equal(got["state"][k], w), k


@pytest.mark.parametrize("static", [False, True], ids=["r2plus1d", "static"])
def test_train_steps_with_remat_equal_the_plain_ones_bit_for_bit(
        static, checkpoints):
    """Dropout and layer-drop at 0.1 (trap 1: the recompute must draw the
    first run's masks), BatchNorm in training mode (trap 2: the running
    statistics move once), two optimizer steps: losses, the gradients
    handed to BertAdam, parameters, running statistics and moments."""
    raw = copy.deepcopy(TRAIN_RAW)
    raw["video"] = {"static": static}
    rng = np.random.default_rng(3)
    batches = [_batch(rng, b=4, frames=4) for _ in range(4)]
    plain = _train(raw, batches)
    assert checkpoints.calls == 0
    rematted = _train(_with_remat(raw), batches)
    assert checkpoints.calls == 2 * len(batches)
    _assert_equal_runs(rematted, plain)
    # the rates are on: the masks moved the loss
    assert not torch.equal(_train(raw, batches[:1], seed=2)["losses"][0],
                           plain["losses"][0])


def test_the_callers_generators_move_once(checkpoints):
    """The audio tower's dropout and layer-drop generators end where they
    end without remat, after the forward and after the backward (whose
    recompute draws from copies), also when one generator serves both."""
    raw = copy.deepcopy(TRAIN_RAW)
    batch = _batch(np.random.default_rng(4), b=2, frames=4)
    wave = torch.from_numpy(batch["audio"])
    ends = {}
    for on in (False, True):
        model = init_model(Config.from_dict(_with_remat(raw, on)),
                           device="cpu")
        for shared in (False, True):
            gen = torch.Generator().manual_seed(5)
            layerdrop = gen if shared else torch.Generator().manual_seed(6)
            out = model.encode_audio(wave, train=True, generator=gen,
                                     layerdrop_generator=layerdrop)
            after_fwd = (gen.get_state(), layerdrop.get_state())
            out.sum().backward()
            ends[on, shared] = (after_fwd, (gen.get_state(),
                                            layerdrop.get_state()),
                                out.detach())
    assert checkpoints.calls == 2
    for shared in (False, True):
        (f0, b0, o0), (f1, b1, o1) = ends[False, shared], ends[True, shared]
        for x, y in zip(f0 + b0, f1 + b1):
            assert torch.equal(x, y)
        assert torch.equal(f1[0], b1[0])  # the backward drew from copies
        assert torch.equal(o0, o1)


def test_calls_that_record_no_graph_skip_the_checkpoint(checkpoints):
    """`eval_step`, `EncoderService` and the export's tracing (under
    `torch.no_grad()`) run the towers as they are: the same embeddings and
    the same exported graph with the flags as without."""
    raw = copy.deepcopy(TRAIN_RAW)
    raw["audio"]["num_layers"] = 1
    models = {on: init_model(Config.from_dict(_with_remat(raw, on)),
                             device="cpu") for on in (False, True)}
    raw_batch = _batch(np.random.default_rng(5), b=2, frames=8,
                       samples=1280)
    batch = ClipBatch(**raw_batch)
    results = {}
    for on, model in models.items():
        v, a, loss = eval_step(model, batch, device="cpu")
        svc = EncoderService(model, model.config, batch_size=2,
                             device="cpu")
        served = svc.embed_audio([raw_batch["audio"][0],
                                  raw_batch["audio"][1][:1000]])
        counts = {}
        for kind, x in (("audio", torch.zeros(2, 1280)),
                        ("video", torch.zeros(2, 8, 32, 32, 3,
                                              dtype=torch.uint8))):
            with torch.no_grad():
                ep = torch.export.export(
                    export._Program(model, kind),
                    (export._tower_state(model.state_dict(), kind), x))
            counts[kind] = sorted(str(n.target) for n in ep.graph.nodes
                                  if n.op == "call_function")
        results[on] = (v, a, loss, served, counts)
    assert checkpoints.calls == 0
    (v0, a0, l0, s0, c0), (v1, a1, l1, s1, c1) = results[False], results[True]
    assert torch.equal(v0, v1) and torch.equal(a0, a1)
    assert torch.equal(l0, l1)
    np.testing.assert_array_equal(s0, s1)
    assert c0 == c1 and len(c0["audio"]) > 0 and len(c0["video"]) > 0


def test_remat_over_two_gloo_ranks_equals_the_plain_run(tmp_path):
    """Two ranks (synchronised BatchNorm: the recompute all-reduces its
    moments again, every rank alike; the global-negative loss), dropout
    and layer-drop at 0.1, two micro-steps of k = 2 (an optimizer step,
    with its gradient all-reduce): remat on equals remat off on each
    rank, bit for bit."""
    W.write_inputs({"data_dir": str(tmp_path / "data")}, str(tmp_path))
    ranks = W.finish_ranks("remat", W.start_ranks("remat", str(tmp_path)),
                           str(tmp_path))
    for r in ranks:
        assert r["remat"]["checkpoints"] == 2 * r["remat"]["micro_steps"]
        assert r["plain"]["checkpoints"] == 0
        assert r["remat"]["losses"] == r["plain"]["losses"]
        assert r["remat"]["digest"] == r["plain"]["digest"]
        assert len(r["plain"]["handed"]) == 1
        for g, w in zip(r["remat"]["handed"], r["plain"]["handed"]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # one optimizer step's mean is the same on both ranks (all-reduced)
    for k, w in ranks[0]["plain"]["handed"][0].items():
        np.testing.assert_array_equal(ranks[1]["plain"]["handed"][0][k], w)
