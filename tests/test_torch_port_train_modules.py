"""The port's training building blocks against the JAX package, on the CPU.

- training-mode `BatchNorm` against peppa_tpu/models/video3d.py::BatchNorm
  (flax 0.12.3, momentum 0.9): output, gradients and running statistics;
- `Dropout`'s keep rate and scaling, statistically, and its determinism;
- `Wav2Vec2` in training mode with `layer_drop=1.0` (every layer dropped)
  against the JAX module;
- BertAdam, its schedules, freezing and gradient accumulation against
  peppa_tpu/training/optimization.py (the cases of tests/test_optimization.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from peppa_tpu.models.video3d import BatchNorm as JaxBatchNorm
from peppa_tpu.models.wav2vec2 import Wav2Vec2 as JaxWav2Vec2
from peppa_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from peppa_tpu.training.optimization import bert_adam as jax_bert_adam
from peppa_tpu.training.optimization import freeze_mask as jax_freeze_mask
from peppa_tpu.training.optimization import \
    freeze_patterns as jax_freeze_patterns
from peppa_tpu.training.optimization import make_optimizer as jax_make_opt
from peppa_tpu.training.optimization import schedule_fn as jax_schedule_fn
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.layers import BatchNorm, Dropout
from peppa_tpu_torch.models.wav2vec2 import Wav2Vec2, Wav2Vec2Config
from peppa_tpu_torch.training.optimization import (BertAdam, freeze_mask,
                                                   freeze_patterns,
                                                   schedule_fn)
from peppa_tpu_torch.training.state import TrainState


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(rng, dtype):
    x = (rng.normal(size=(4, 3, 5, 6, 16)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbn = JaxBatchNorm(jdt)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = jax.tree.map(lambda p: p + 0.1, variables["params"])
    stats = jax.tree.map(lambda s: s + 0.5, variables["batch_stats"])

    def f(params, x):
        y, mut = jbn.apply({"params": params, "batch_stats": stats},
                           x.astype(jdt), False, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, mut)

    (_, (jy, jmut)), jg = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(x))
    bn = BatchNorm(16, tdt)
    load_jax_variables(bn, {"params": jax.tree.map(np.asarray, params),
                            "batch_stats": jax.tree.map(np.asarray, stats)})
    # channels-first, as the port's video tower calls it
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(tdt).requires_grad_()
    y = bn(tx, train=True)
    assert y.dtype == tdt
    torch.sum(y.float() * torch.from_numpy(w).permute(0, 4, 1, 2, 3)
              ).backward()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        y.detach().float().permute(0, 2, 3, 4, 1).numpy(),
        np.asarray(jy, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        tx.grad.float().permute(0, 2, 3, 4, 1).numpy(),
        np.asarray(jg[1], np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(jg[0]["bn"]["scale"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(jg[0]["bn"]["bias"]), rtol=1e-4,
                               atol=1e-4)
    # running statistics: 0.9 running + 0.1 batch, biased variance
    new = jmut["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-6, atol=1e-6)


def test_batchnorm_eval_does_not_update(rng):
    bn = BatchNorm(8, torch.float32)
    x = torch.from_numpy(rng.normal(size=(2, 8, 3, 4, 4)).astype(np.float32))
    bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(8))
    assert torch.equal(bn.running_var, torch.ones(8))


# --------------------------------------------------------------- Dropout
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.full((1000, 1000), 2.0)
    y = Dropout(rate)(x, False, torch.Generator().manual_seed(0))
    kept = y != 0
    keep = 1.0 - rate
    sigma = (keep * rate / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sigma
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / keep))
    # expectation preserved
    assert abs(y.mean().item() - 2.0) < 5 * 2.0 / keep * sigma


def test_dropout_identity_zeros_and_determinism():
    x = torch.randn(64, 64)
    assert Dropout(0.3)(x, True) is x
    assert Dropout(0.0)(x, False) is x
    assert not Dropout(1.0)(x, False).any()
    a = Dropout(0.3)(x, False, torch.Generator().manual_seed(7))
    b = Dropout(0.3)(x, False, torch.Generator().manual_seed(7))
    c = Dropout(0.3)(x, False, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.3)(x, False)


# ------------------------------------------------------- wav2vec2 layer-drop
_SMALL = dict(embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
              pos_conv_kernel=8, pos_conv_groups=4)


def test_wav2vec2_layer_drop_one_drops_every_layer(rng):
    """layer_drop=1.0 with the other rates 0: the training forward skips
    every transformer layer, deterministically, in both packages."""
    rates = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                 layer_drop=1.0)
    jmod = JaxWav2Vec2(JaxW2VConfig(**_SMALL, **rates))
    wave = rng.normal(scale=0.1, size=(2, 1600)).astype(np.float32)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(wave))
    want, _ = jax.jit(lambda v, x, rngs: jmod.apply(
        v, x, deterministic=False, tap="context", rngs=rngs))(
            variables, jnp.asarray(wave),
            {"dropout": jax.random.PRNGKey(1),
             "layerdrop": jax.random.PRNGKey(2)})
    port = Wav2Vec2(Wav2Vec2Config(**_SMALL, **rates))
    load_jax_variables(port, jax.tree.map(np.asarray, variables))
    got, _ = port(torch.from_numpy(wave), deterministic=False, tap="context",
                  generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # every layer dropped: the context is the encoder input itself
    deterministic, _ = port(torch.from_numpy(wave), tap="context")
    assert not torch.allclose(got, deterministic)
    port.cfg = Wav2Vec2Config(**{**_SMALL, "num_layers": 0}, **rates)
    skipped, _ = port(torch.from_numpy(wave), tap="context")
    torch.testing.assert_close(got, skipped, rtol=0, atol=0)


def test_wav2vec2_training_forward_is_seeded(rng):
    port = Wav2Vec2(Wav2Vec2Config(**_SMALL, layer_drop=0.5))
    wave = torch.from_numpy(rng.normal(scale=0.1, size=(2, 1600))
                            .astype(np.float32))
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())) * 0.1)
        run = lambda seed: port(wave, deterministic=False, tap="context",
                                generator=torch.Generator().manual_seed(seed)
                                )[0]
        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))


# ---------------------------------------------------------------- BertAdam
class _OptCfg:
    lr, warmup, schedule, t_total = 0.1, 0.1, "warmup_linear", 100
    b1, b2, e, weight_decay, max_grad_norm = 0.9, 0.999, 1e-6, 0.01, 1.0


@pytest.mark.parametrize("schedule", ["warmup_linear", "warmup_constant",
                                      "warmup_cosine"])
@pytest.mark.parametrize("t_total", [100, -1])
def test_schedules_match_jax(schedule, t_total):
    want = jax_schedule_fn(schedule, 2.0, 0.1, t_total)
    got = schedule_fn(schedule, 2.0, 0.1, t_total)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        assert got(step) == pytest.approx(float(want(jnp.asarray(step))),
                                          rel=1e-6, abs=1e-7)


def _run_jax(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params)


def _run_port(state: TrainState, grads):
    for g in grads:
        for name, p in state.model.named_parameters():
            p.grad = torch.from_numpy(np.array(g[name]))
        state.apply_gradients()
    return {k: p.detach().numpy() for k, p in state.model.named_parameters()}


def _module(**tensors) -> nn.Module:
    """A module whose parameters carry the given dotted names."""
    root = nn.Module()
    for name, value in tensors.items():
        *mods, leaf = name.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, nn.Parameter(torch.from_numpy(value)))
    return root


def _config(accumulate=1, freeze_feature_extractor=False,
            freeze_encoder_layers=None, **opt):
    cfg = Config()
    cfg.training.accumulate_grad_batches = accumulate
    cfg.audio.freeze_feature_extractor = freeze_feature_extractor
    cfg.audio.freeze_encoder_layers = freeze_encoder_layers
    for k, v in {**{k: getattr(_OptCfg, k) for k in (
            "lr", "warmup", "schedule", "t_total", "b1", "b2", "e",
            "weight_decay", "max_grad_norm")}, **opt}.items():
        setattr(cfg.optimizer, k, v)
    return cfg


def test_bert_adam_matches_jax(rng):
    """5 steps, warmup_linear (the first at lr 0), per-tensor clipping (one
    tensor's gradient far above max_grad_norm), decoupled decay."""
    p0 = {"a": rng.normal(size=(7,)).astype(np.float32),
          "b": rng.normal(size=(3, 4)).astype(np.float32)}
    grads = [{"a": rng.normal(size=(7,)).astype(np.float32) * 30,
              "b": rng.normal(size=(3, 4)).astype(np.float32) * 0.01}
             for _ in range(5)]
    want = _run_jax(jax_bert_adam(lr=0.1, warmup=0.1, t_total=100),
                    {k: jnp.asarray(v) for k, v in p0.items()},
                    [{k: jnp.asarray(v) for k, v in g.items()}
                     for g in grads])
    got = _run_port(TrainState.create(_module(**p0), _config()), grads)
    for k in p0:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_first_step_lr_is_zero_with_warmup():
    model = _module(w=np.ones(3, np.float32))
    state = TrainState.create(model, _config(lr=0.5, t_total=10))
    got = _run_port(state, [{"w": np.ones(3, np.float32)}])
    np.testing.assert_array_equal(got["w"], 1.0)
    assert state.optimizer.param_groups[0]["step"] == 1


def test_per_tensor_clipping_independent():
    opt_params = [nn.Parameter(torch.zeros(4)), nn.Parameter(torch.zeros(4))]
    opt = BertAdam(opt_params, lr=1.0, warmup=0.5, t_total=2,
                   weight_decay=0.0)
    opt_params[0].grad = torch.full((4,), 100.0)
    opt_params[1].grad = torch.full((4,), 0.001)
    opt.step()
    m_a = opt.state[opt_params[0]]["m"].numpy()
    assert np.linalg.norm(m_a / 0.1) == pytest.approx(1.0, rel=1e-4)
    np.testing.assert_allclose(opt.state[opt_params[1]]["m"].numpy(),
                               0.1 * 0.001, rtol=1e-5)


def test_freeze_patterns_and_mask_match_jax():
    tree = {"audio_encoder": {"wav2vec2": {
        "feature_extractor": {"conv0": {"kernel": 1}},
        "layer0": {"attention": {"q_proj": {"kernel": 1}}},
        "layer1": {"attention": {"q_proj": {"kernel": 1}}},
        "layer10": {"ffn_in": {"kernel": 1}},
        "aux": {"kernel": 1}}},
        "video_encoder": {"project": {"kernel": 1}}}
    for fe, n in ((True, 1), (False, 2), (True, None), (False, None)):
        pats = freeze_patterns(fe, n)
        assert list(pats) == list(jax_freeze_patterns(fe, n))
        flat = jax.tree_util.tree_flatten_with_path(
            jax_freeze_mask(tree, pats))[0]
        want = {"/".join(k.key for k in path): v for path, v in flat}
        assert freeze_mask(want, pats) == want
        dotted = freeze_mask([k.replace("/", ".") for k in want], pats)
        assert list(dotted.values()) == list(want.values())


def test_frozen_params_do_not_move_as_in_jax():
    p0 = {"audio_encoder.wav2vec2.feature_extractor.conv0.kernel":
          np.ones(3, np.float32),
          "audio_encoder.wav2vec2.aux.kernel": np.ones(3, np.float32)}
    jtree = {"audio_encoder": {"wav2vec2": {
        "feature_extractor": {"conv0": {"kernel": jnp.ones(3)}},
        "aux": {"kernel": jnp.ones(3)}}}}

    class OC(_OptCfg):
        lr, warmup, schedule, t_total = 0.1, 0.01, "warmup_constant", 100

    want = _run_jax(jax_make_opt(OC, accumulate_grad_batches=1,
                                 freeze_feature_extractor=True,
                                 params=jtree),
                    jtree, [jax.tree.map(jnp.ones_like, jtree)] * 3)
    state = TrainState.create(_module(**p0), _config(
        freeze_feature_extractor=True, lr=0.1, warmup=0.01,
        schedule="warmup_constant"))
    assert list(state.params) == ["audio_encoder.wav2vec2.aux.kernel"]
    got = _run_port(state, [{k: np.ones(3, np.float32) for k in p0}] * 3)
    np.testing.assert_array_equal(
        got["audio_encoder.wav2vec2.feature_extractor.conv0.kernel"], 1.0)
    np.testing.assert_allclose(
        got["audio_encoder.wav2vec2.aux.kernel"],
        want["audio_encoder"]["wav2vec2"]["aux"]["kernel"], rtol=1e-6)


def test_grad_accumulation_matches_multisteps(rng):
    """k=2 over 6 micro-steps: the Welford mean of each pair, one BertAdam
    step per pair, parameters still between the two."""
    p0 = rng.normal(size=(4,)).astype(np.float32)
    grads = [rng.normal(size=(4,)).astype(np.float32) for _ in range(6)]

    class OC(_OptCfg):
        lr, warmup, schedule, t_total = 0.1, 0.5, "warmup_constant", 10
        weight_decay, max_grad_norm = 0.0, -1.0

    tx = jax_make_opt(OC, accumulate_grad_batches=2,
                      params={"w": jnp.asarray(p0)})
    state = TrainState.create(_module(w=p0.copy()), _config(
        accumulate=2, warmup=0.5, schedule="warmup_constant", t_total=10,
        weight_decay=0.0, max_grad_norm=-1.0))
    jstate = tx.init({"w": jnp.asarray(p0)})
    params = {"w": jnp.asarray(p0)}
    for i, g in enumerate(grads):
        updates, jstate = tx.update({"w": jnp.asarray(g)}, jstate, params)
        params = optax.apply_updates(params, updates)
        got = _run_port(state, [{"w": g}])["w"]
        np.testing.assert_allclose(got, np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-7)
        if i % 2 == 0:  # mid-group: nothing moved since the last update
            np.testing.assert_allclose(
                state.acc_grads["w"].numpy(),
                np.asarray(jstate.acc_grads["w"]), rtol=1e-6)
    assert state.step == 6 and state.optimizer.param_groups[0]["step"] == 3
