"""W8A8 int8 serving in the port (`peppa_tpu_torch/ops/quant.py`, the
`quant` flag of `models/layers.py`'s `Dense` and `Conv` in every tower)
against the JAX package's `peppa_tpu/ops/quant.py` and
`peppa_tpu/models/qlayers.py`, on the CPU.

- The primitives: the counterparts of `tests/test_quant.py`'s seven cases,
  and `int8_conv` / `int8_matmul` equal to the JAX package's bit for bit in
  float32 and bf16 (1-D, 2-D and 3-D convs with the towers' strides and
  paddings; out channels 45 and 230, K = 147: widths that are not
  multiples of 8), through the plain version and through the card route
  (im2col + padded `torch._int_mm`) run on CPU tensors.
- Coverage: the int8 products of one forward, counted on the JAX side by
  wrapping `peppa_tpu.models.qlayers.int8_conv` / `int8_matmul` and
  `peppa_tpu.models.video3d.int8_conv` here (the package is not changed),
  equal to the port's counters for each tower.
- Towers: an int8 forward is chaotic at rounding ties.  One float32 ulp
  before a quantization can move an int8 value by one, and the change
  grows through the later layers.  Left to run on their own, the two
  packages' int8 embeddings here differ by up to 1.85e-3 (the audio tower
  on every seed, the video towers on 6 of 12 tower-seeds), as much as int8
  differs from float (1.10e-3 to 5.33e-3).  So the tower test feeds each
  of the port's int8 products the JAX call's input: it holds the port's
  own input to it (the float work between the products) within GLUE_TOL,
  the product's output equal to the JAX call's bit for bit, and the
  embedding within TOL of the JAX int8 embedding, at least 10x below the
  int8-versus-float difference.  Measured over seeds 0-2 and the five
  towers: glue 3.06e-7 at most, embeddings 8.94e-8 at most.
- Training forwards with the flag are the float ones bit for bit, and
  `EncoderService.from_checkpoint(..., quantize_int8=True)` serves the
  model built with the flag.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peppa_tpu.models.qlayers as jax_qlayers
import peppa_tpu.models.video3d as jax_video3d
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.ops import quant as jax_quant
import peppa_tpu_torch.models.layers as layers
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.convert import (export_jax_variables,
                                            load_jax_variables)
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from peppa_tpu_torch.models.video3d import R3DEncoder
from peppa_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from peppa_tpu_torch.ops import quant
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training import checkpoint as C
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.utils.profiling import counters
from test_torch_port_convert import (_drop_large_files,  # noqa: F401
                                     _random, _two_threads)

RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}},
       "tpu": {"quantize_int8": True}}
TOWERS = {"wav2vec2": {}, "r2plus1d_18": {}, "r3d_18": {"version": "r3d_18"},
          "mc3_18": {"version": "mc3_18"}, "static": {"static": True}}
# int8 products per forward: wav2vec2 conv1-6, proj and 6 per layer; the
# video trunks' convs
PRODUCTS = {"wav2vec2": 6 + 1 + 6 * 2, "r2plus1d_18": 37, "r3d_18": 20,
            "mc3_18": 20, "static": 20}
SEEDS = (0, 1, 2)
# the port's own input to each int8 product against the JAX call's, as a
# share of its largest |value| (the float work between two products); the
# embeddings of the two packages with every product fed the JAX inputs
GLUE_TOL = 1e-5
TOL = 1e-6
TINY_W2V = Wav2Vec2Config(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64,
                          num_out=28, pos_conv_kernel=16, pos_conv_groups=4,
                          layer_drop=0.0)
_JAX_DN = {1: ("NWC", "WIO", "NWC"), 2: ("NHWC", "HWIO", "NHWC"),
           3: ("NDHWC", "DHWIO", "NDHWC")}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------- tests/test_quant.py's seven cases

def test_quantize_maps_zero_to_zero():
    x = torch.tensor([[0.0, 0.5, -1.0], [0.0, 0.0, 0.0]])
    q = quant.quantize_int8(x, quant.act_scale(x))
    assert q.dtype == torch.int8 and int(q[0, 0]) == 0
    assert torch.all(q[1] == 0)  # zero-padding rows stay exactly 0


def test_weight_scale_per_output_channel():
    """The output channel is axis 0 in the port's layouts."""
    w = torch.stack([torch.full((3, 4), 0.5), torch.full((3, 4), 2.0)])
    s = quant.absmax_weight_scale(w)
    assert s.shape == (2, 1, 1)
    np.testing.assert_allclose(s.ravel().numpy(), [0.5 / 127, 2.0 / 127],
                               rtol=1e-6)


def test_int8_matmul_close_to_float():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=gen)
    w = torch.randn(32, 64, generator=gen) * 0.1
    y_ref = x @ w.T
    y_q = quant.int8_matmul(x, w, torch.float32)
    assert (y_q - y_ref).abs().max() / y_ref.abs().max() < 0.02


def test_int8_conv_close_to_float():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 5, 10, 12, generator=gen)
    w = torch.randn(24, 16, 1, 3, 3, generator=gen) * 0.1
    y_ref = torch.nn.functional.conv3d(x, w, None, 1, (0, 1, 1))
    y_q = quant.int8_conv(x, w, (1, 1, 1), (0, 1, 1), torch.float32)
    assert y_q.shape == y_ref.shape
    assert (y_q - y_ref).abs().max() / y_ref.abs().max() < 0.02


@pytest.mark.parametrize("route", ["plain", "card_route"])
def test_int8_conv_zero_padding_rows_exact(monkeypatch, route):
    """Zero-padded batch rows give exactly the all-zero-input output."""
    if route == "card_route":
        monkeypatch.setattr(quant, "_device_of", lambda x: "cuda")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 8, 4, 6, 6, generator=gen)
    x = torch.cat([x, torch.zeros_like(x)])
    w = torch.randn(8, 8, 1, 3, 3, generator=gen)
    y = quant.int8_conv(x, w, (1, 1, 1), (0, 1, 1), torch.float32)
    assert torch.all(y[1] == 0.0)


def test_quant_flag_keeps_param_tree_identical():
    """The flag adds no parameter: the JAX package's int8 model's
    variables load into the port's int8 model, and it exports them back."""
    raw = {**RAW, "audio": {"num_layers": 1}}
    jm = JaxPeppaPig(JaxConfig.from_dict(raw))
    video = jnp.zeros((1, 3, 24, 32, 3), jnp.float32)

    def tree(method, key, x):
        """The variables `jm.init` makes, as zeros of their shapes and
        dtypes (traced, not run: the eager init takes a minute here)."""
        shapes = jax.eval_shape(functools.partial(jm.init, method=method),
                                jax.random.PRNGKey(key), x)
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)

    variables = tree(jm.encode_video, 0, video)
    audio_vars = tree(jm.encode_audio, 1, jnp.zeros((1, 1600), jnp.float32))
    variables["params"].update(audio_vars["params"])
    port = PeppaPig(Config.from_dict(raw))
    load_jax_variables(port, variables)
    back = export_jax_variables(port)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    float_port = PeppaPig(Config.from_dict({**raw, "tpu": {}}))
    assert ({k: v.shape for k, v in port.state_dict().items()}
            == {k: v.shape for k, v in float_port.state_dict().items()})


def test_quant_embeddings_close_to_float():
    """int8 eval embeddings within cosine 0.99 of the float ones, and the
    training forward not quantized (bit for bit the float one)."""
    gen = torch.Generator().manual_seed(7)
    video = torch.rand(2, 4, 16, 16, 3, generator=gen)
    enc_f = _random(R3DEncoder(version="r3d_18"), seed=7)
    enc_q = R3DEncoder(version="r3d_18", quant=True)
    enc_q.load_state_dict(enc_f.state_dict())
    with torch.no_grad():
        cos = (enc_f(video) * enc_q(video)).sum(dim=1)
    assert cos.min() > 0.99, cos

    audio = torch.randn(2, 6400, generator=gen) * 0.1
    a_f = _random(Wav2Vec2Encoder(cfg=TINY_W2V, use_pallas=False), seed=7)
    a_q = Wav2Vec2Encoder(cfg=TINY_W2V, use_pallas=False, quant=True)
    a_q.load_state_dict(a_f.state_dict())
    with torch.no_grad():
        cos_a = (a_f(audio) * a_q(audio)).sum(dim=1)
    assert cos_a.min() > 0.99, cos_a

    with torch.no_grad():
        t_f = copy.deepcopy(enc_f)(video, train=True)
        t_q = copy.deepcopy(enc_q)(video, train=True)
    assert torch.equal(t_f, t_q)


# ------------------------------------------------ the primitives, bit for bit

# (x shape, w shape (O, C, *kernel), stride, padding), as the towers use them
CONV_CASES = {
    "w2v_conv1": ((2, 16, 41), (24, 16, 3), (2,), (0,)),
    "w2v_conv6": ((2, 16, 9), (16, 16, 2), (2,), (0,)),
    "r2p1d_stem_spatial_45": ((2, 3, 3, 20, 18), (45, 3, 1, 7, 7),
                              (1, 2, 2), (0, 3, 3)),
    "r2p1d_stem_temporal": ((2, 45, 3, 10, 9), (64, 45, 3, 1, 1),
                            (1, 1, 1), (1, 0, 0)),
    "r2p1d_spatial_230": ((2, 64, 3, 10, 9), (230, 64, 1, 3, 3), (1, 2, 2),
                          (0, 1, 1)),
    "r2p1d_temporal_k690": ((2, 230, 4, 5, 5), (128, 230, 3, 1, 1),
                            (2, 1, 1), (1, 0, 0)),
    "r2p1d_downsample": ((2, 64, 4, 6, 6), (128, 64, 1, 1, 1), (2, 2, 2),
                         (0, 0, 0)),
    "r3d_stem_k441": ((2, 3, 3, 12, 10), (64, 3, 3, 7, 7), (1, 2, 2),
                      (1, 3, 3)),
    "r3d_conv": ((2, 8, 4, 6, 6), (16, 8, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "static_stem_k147": ((3, 3, 16, 18), (64, 3, 7, 7), (2, 2), (3, 3)),
    "static_downsample": ((3, 8, 9, 9), (16, 8, 1, 1), (2, 2), (0, 0)),
}
# (x shape, N): K = 147 and N = 45 / 230 / 921, and M <= 16
MATMUL_CASES = {"k147_n45": ((2, 7, 147), 45), "k64_n230_m15": ((3, 5, 64),
                                                               230),
                "k768_n921": ((40, 768), 921)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _route(monkeypatch, route):
    """'card_route': the CUDA route on CPU tensors (`_device_of` says
    cuda), with the plain versions made to raise."""
    if route == "card_route":
        monkeypatch.setattr(quant, "_device_of", lambda x: "cuda")
        for name in ("conv_acc_plain", "matmul_acc_plain"):
            monkeypatch.setattr(quant, name, _refuse)


def _refuse(*args, **kw):
    raise AssertionError("the plain version ran on the card route")


def _inputs(x_shape, w_shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32))
    w = (rng.normal(size=w_shape) * 0.1).astype(np.float32)
    return x.to(dtype), w


@functools.lru_cache(maxsize=None)
def _jax_conv(case, dtype):
    """The JAX package's `int8_conv` on the case's inputs, in the port's
    layout as float32 (the plain and card-route cases share it)."""
    x_shape, w_shape, stride, padding = CONV_CASES[case]
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs(x_shape, w_shape, tdt)
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    jx = jnp.moveaxis(jx, 1, -1)  # channels last
    jw = jnp.asarray(np.moveaxis(w, (0, 1), (-1, -2)))  # (*k, C, O)
    want = jax_quant.int8_conv(jx, jw, stride, [(p, p) for p in padding],
                               _JAX_DN[len(stride)], out_dtype=jdt)
    return torch.from_numpy(np.moveaxis(
        np.asarray(want.astype(jnp.float32)), -1, 1).copy())


@functools.lru_cache(maxsize=None)
def _jax_matmul(case, dtype):
    """The JAX package's `int8_matmul` on the case's inputs, as float32."""
    x_shape, n = MATMUL_CASES[case]
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs(x_shape, (n, x_shape[-1]), tdt, seed=1)
    return _t(jax_quant.int8_matmul(
        jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(w.T),
        out_dtype=jdt).astype(jnp.float32))


@pytest.mark.parametrize("route", ["plain", "card_route"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_jax_bit_for_bit(monkeypatch, case, dtype, route):
    x_shape, w_shape, stride, padding = CONV_CASES[case]
    tdt, _ = DTYPES[dtype]
    x, w = _inputs(x_shape, w_shape, tdt)
    want = _jax_conv(case, dtype)
    _route(monkeypatch, route)
    before = counters()["int8_conv.calls"]
    got = quant.int8_conv(x, torch.from_numpy(w), stride, padding, tdt)
    assert counters()["int8_conv.calls"] == before + 1
    assert got.dtype == tdt and got.shape == want.shape
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("route", ["plain", "card_route"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_int8_matmul_matches_jax_bit_for_bit(monkeypatch, case, dtype,
                                             route):
    x_shape, n = MATMUL_CASES[case]
    tdt, _ = DTYPES[dtype]
    x, w = _inputs(x_shape, (n, x_shape[-1]), tdt, seed=1)
    want = _jax_matmul(case, dtype)
    _route(monkeypatch, route)
    before = counters()["int8_matmul.calls"]
    got = quant.int8_matmul(x, torch.from_numpy(w), tdt)
    assert counters()["int8_matmul.calls"] == before + 1
    assert got.dtype == tdt and torch.equal(got.float(), want)


@pytest.mark.parametrize("case", ["r2p1d_spatial_230", "static_stem_k147",
                                  "w2v_conv1"])
def test_card_route_accumulator_equals_plain(case):
    """The int32 accumulators of the two routes, equal on int8 inputs."""
    x_shape, w_shape, stride, padding = CONV_CASES[case]
    gen = torch.Generator().manual_seed(3)
    xq = torch.randint(-127, 128, x_shape, generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, w_shape, generator=gen).to(torch.int8)
    want = quant.conv_acc_plain(xq, wq, stride, padding)
    assert torch.equal(quant.conv_acc_mm(xq, wq, stride, padding), want)
    x2 = xq.reshape(-1, xq.shape[-1])[:13]
    w2 = wq.reshape(wq.shape[0], -1)[:, :x2.shape[1]]
    assert torch.equal(quant.matmul_acc_mm(x2, w2),
                       quant.matmul_acc_plain(x2, w2))


# ------------------------------------------------------------ the towers

_SEED0_PORTS = {}


def _port_tower(tower, seed):
    """The port's model of `tower` with seeded weights; seed 0's is built
    once (the coverage test and the tower test both read it)."""
    if seed == 0 and tower in _SEED0_PORTS:
        return _SEED0_PORTS[tower]
    raw = {**RAW, "video": TOWERS[tower]}
    port = _random(PeppaPig(Config.from_dict(raw)), seed=seed)
    if seed == 0:
        _SEED0_PORTS[tower] = port
    return port


_JAX_RUNS = {}


def _jax_run(tower, seed, port):
    """The JAX package's forwards of `tower` on `port`'s weights (the
    seed's): (its int8 calls in order, each (kind, input, output), the int8
    embedding, the float embedding); computed once per (tower, seed), so
    the coverage test and the tower test's seed 0 share them."""
    if (tower, seed) not in _JAX_RUNS:
        raw = {**RAW, "video": TOWERS[tower]}
        variables = export_jax_variables(port)
        jq = JaxPeppaPig(JaxConfig.from_dict(raw))
        jf = JaxPeppaPig(JaxConfig.from_dict({**raw, "tpu": {}}))
        with pytest.MonkeyPatch.context() as mp:
            calls = _record_jax(mp)
            want = _encode_jax(jq, variables, tower, seed)
        _JAX_RUNS[tower, seed] = (calls, want,
                                  _encode_jax(jf, variables, tower, seed))
    return _JAX_RUNS[tower, seed]


def _tower_inputs(seed):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, size=(2, 9, 24, 32, 3), dtype=np.uint8)
    audio = rng.normal(scale=0.1, size=(2, 3200)).astype(np.float32)
    return video, np.array([9, 5], np.int32), audio


def _encode_jax(model, variables, tower, seed):
    video, lengths, audio = _tower_inputs(seed)
    if tower == "wav2vec2":
        return np.asarray(model.apply(variables, audio,
                                      method=model.encode_audio))
    return np.asarray(model.apply(variables, video, lengths,
                                  method=model.encode_video))


def _encode_port(port, tower, seed, train=False):
    video, lengths, audio = _tower_inputs(seed)
    with torch.no_grad():
        if tower == "wav2vec2":
            return port.encode_audio(
                torch.from_numpy(audio), train=train,
                generator=torch.Generator().manual_seed(0)).numpy()
        return port.encode_video(torch.from_numpy(video),
                                 torch.from_numpy(lengths),
                                 train=train).numpy()


def _record_jax(monkeypatch):
    """Wrap the JAX package's int8 entry points (its module attributes,
    here only): each call's kind, input and output, in order."""
    calls = []

    def wrap(real, kind):
        def run(x, w, *args, **kw):
            y = real(x, w, *args, **kw)
            calls.append((kind, np.asarray(x), np.asarray(y)))
            return y
        return run

    monkeypatch.setattr(jax_qlayers, "int8_conv",
                        wrap(jax_qlayers.int8_conv, "conv"))
    monkeypatch.setattr(jax_qlayers, "int8_matmul",
                        wrap(jax_qlayers.int8_matmul, "matmul"))
    monkeypatch.setattr(jax_video3d, "int8_conv",
                        wrap(jax_video3d.int8_conv, "conv"))
    return calls


def _to_port_layout(kind, a):
    if kind == "conv":  # channels last -> channels first
        a = np.moveaxis(a, -1, 1)
    return torch.from_numpy(np.array(a))


def _feed_jax_inputs(monkeypatch, calls):
    """Wrap the port's int8 entry points (as `models/layers.py` calls
    them): the i-th product takes the i-th JAX call's input once the port's
    own input is held within GLUE_TOL of it, and its output must equal the
    JAX call's.  The JAX package's space-to-depth stem re-lays its input
    out, so there the port's own input goes in, and the output must still
    be equal.  Returns the largest glue difference seen."""
    seen = {"n": 0, "glue": 0.0}

    def wrap(real, kind):
        def run(x, w, *args):
            i = seen["n"]
            seen["n"] += 1
            jkind, jx, jy = calls[i]
            assert jkind == kind, (i, jkind, kind)
            jx = _to_port_layout(kind, jx)
            if jx.shape == x.shape:
                glue = float((x - jx).abs().max() / jx.abs().max())
                assert glue <= GLUE_TOL, (i, kind, glue)
                seen["glue"] = max(seen["glue"], glue)
                x = jx
            y = real(x, w, *args)
            assert torch.equal(y, _to_port_layout(kind, jy)), (i, kind)
            return y
        return run

    monkeypatch.setattr(layers, "int8_conv", wrap(layers.int8_conv, "conv"))
    monkeypatch.setattr(layers, "int8_matmul",
                        wrap(layers.int8_matmul, "matmul"))
    return seen


def _products() -> int:
    """int8 products run so far (the counters `chip_smoke.py` reads)."""
    now = counters()
    return now["int8_conv.calls"] + now["int8_matmul.calls"]


@pytest.mark.parametrize("tower", list(TOWERS))
def test_int8_products_cover_the_jax_layers(monkeypatch, tower):
    """One eval forward runs as many int8 products as the JAX package's,
    read from the counters that `chip_smoke.py` reads."""
    port = _port_tower(tower, seed=0)
    calls = _jax_run(tower, 0, port)[0]
    before = _products()
    _encode_port(port, tower, seed=0)
    got = _products() - before
    assert got == len(calls) == PRODUCTS[tower]


@pytest.mark.parametrize("tower", list(TOWERS))
def test_int8_tower_matches_jax(monkeypatch, tower):
    """Per seed: every product equal to the JAX call's on its input, the
    glue within GLUE_TOL, the embedding within TOL of the JAX int8 one and
    TOL at least 10x below the JAX int8-versus-float difference."""
    for seed in SEEDS:
        port = _port_tower(tower, seed)
        monkeypatch.undo()
        calls, want, float_want = _jax_run(tower, seed, port)
        float_diff = np.abs(want - float_want).max()
        seen = _feed_jax_inputs(monkeypatch, calls)
        got = _encode_port(port, tower, seed)
        assert seen["n"] == len(calls) == PRODUCTS[tower]
        err = np.abs(got - want).max()
        assert err <= TOL, (seed, err)
        assert 10 * TOL <= float_diff, (seed, float_diff)


def test_training_forward_is_the_float_one():
    """With the flag, a training forward (batch statistics, dropout and
    layer-drop) runs no int8 product and gives the float path's bits."""
    cfg_q = Config.from_dict({**RAW, "audio": {"num_layers": 2,
                                               "dropout": 0.1}})
    q = _random(PeppaPig(cfg_q), seed=3)
    f = PeppaPig(Config.from_dict({**RAW, "tpu": {},
                                   "audio": {"num_layers": 2,
                                             "dropout": 0.1}}))
    f.load_state_dict(q.state_dict())
    before = _products()
    for tower in ("wav2vec2", "r2plus1d_18"):
        got = _encode_port(q, tower, seed=3, train=True)
        want = _encode_port(f, tower, seed=3, train=True)
        np.testing.assert_array_equal(got, want)
    assert _products() == before
    for (name, a), b in zip(q.state_dict().items(),
                            f.state_dict().values()):
        assert torch.equal(a, b), name  # the same running statistics


def test_from_checkpoint_serves_int8(tmp_path):
    """`from_checkpoint(quantize_int8=True)` over a float run directory:
    the model rebuilt with the flag on the checkpoint's weights."""
    cfg = Config.from_dict({**RAW, "tpu": {}})
    model = _random(PeppaPig(cfg), seed=4)
    vdir = str(tmp_path / "version_0")
    os.makedirs(os.path.join(vdir, "checkpoints"))
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    path = os.path.join(vdir, "checkpoints",
                        "epoch=0-valnarr_triplet=0.75.ckpt")
    C.save_checkpoint(path, TrainState.create(model, cfg), {
        "monitor": "valnarr_triplet", "mode": "max",
        "best_model_score": 0.75, "best_model_path": path, "epoch": 0,
        "metrics": {}})
    svc = EncoderService.from_checkpoint(vdir, device="cpu",
                                         quantize_int8=True, buckets=(2.3,),
                                         batch_size=2)
    assert svc.config.tpu.quantize_int8 is True
    built = PeppaPig(Config.from_dict(RAW))
    built.load_state_dict(model.state_dict())
    mem = EncoderService(built, Config.from_dict(RAW), device="cpu",
                         buckets=(2.3,), batch_size=2)
    video, _, audio = _tower_inputs(4)
    waves = [audio[0][:1840], audio[1][:1500]]
    before = counters()["int8_matmul.calls"]
    got = svc.embed_audio(waves)
    assert counters()["int8_matmul.calls"] == before + 1 + 6 * 2
    np.testing.assert_array_equal(got, mem.embed_audio(waves))
    np.testing.assert_array_equal(svc.embed_video(list(video)),
                                  mem.embed_video(list(video)))
    float_svc = EncoderService.from_checkpoint(vdir, device="cpu",
                                               buckets=(2.3,), batch_size=2)
    assert float_svc.config.tpu.quantize_int8 is False
    assert not np.array_equal(got, float_svc.embed_audio(waves))
