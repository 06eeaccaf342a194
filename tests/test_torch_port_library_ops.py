"""Kernel 2 and the loss as dispatcher ops with autograd, on the CPU.

- `torch.library.opcheck` of the port's four ops (the attention forward,
  its training form with the log-sum-exp, its backward, the loss with its
  gradient) in float32 and bfloat16, the attention with and without key
  lengths: schema, fake tensors, the autograd registration and the
  AOT-dispatched run against the eager one.
- The training op's (out, dq, dk, dv) against the JAX package's `_attend`
  custom VJP (the Pallas kernels in interpret mode), and the loss op's
  (loss, dV, dA) against `fused_triplet_loss` and `jax.grad` of it, at the
  tolerances of tests/test_torch_port_train_kernels.py; the log-sum-exp
  against float64 in the kernels' units.
- `torch.compile(backend="aot_eager", fullgraph=True)` of the audio tower
  in training mode on the kernel route (`audio.dropout: 0.0`, so no
  dropout and no layer-drop) followed by the loss, forward and backward:
  equal to eager bit for bit, its graphs hold the ops by name and no
  `autograd.Function`.
- A fresh process's first calls of the ops, forward and backward, import
  no `torch._dynamo` (the cost `torch.library.custom_op` brings).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.ops.pallas.attention import mha_attention as jax_mha
from peppa_tpu.ops.pallas.loss import fused_triplet_loss as jax_fused_loss
from peppa_tpu_torch.ops.cuda import attention, loss
from test_torch_port_trainer import _two_threads  # noqa: F401
from torch_port_loss_data import mixed_activity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-4, "bf16": 2e-2}  # test_torch_port_train_kernels.py's
LENGTHS = {"full": None, "ragged": (40, 17)}


def _qkv(dtype, seed=0, shape=(2, 40, 2, 16)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _torch(x, dtype, grad=False):
    return torch.from_numpy(x).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_opcheck_attention_ops(dtype, lengths):
    q, k, v, do = (_torch(x, DTYPES[dtype]) for x in _qkv(dtype))
    lens = None if LENGTHS[lengths] is None \
        else torch.tensor(LENGTHS[lengths])
    scale = 16 ** -0.5
    torch.library.opcheck(attention.attention_op, (q, k, v, lens, scale))
    grads = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    torch.library.opcheck(attention.attention_train_op,
                          (*grads, lens, scale))
    out, lse = attention.attention_train_op(q, k, v, lens, scale)
    torch.library.opcheck(attention.attention_bwd_op,
                          (q, k, v, do, lens, scale, lse, out))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_opcheck_loss_op(dtype):
    v, a = (torch.from_numpy(x).to(DTYPES[dtype]).requires_grad_()
            for x in mixed_activity(13, 100, seed=113))
    torch.library.opcheck(loss.loss_op, (v, a, 0.2))


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_training_op_matches_the_jax_custom_vjp(dtype, lengths):
    """(out, dq, dk, dv) for one output gradient, through the op's
    autograd, against `jax.vjp` of the JAX package's `mha_attention` (its
    `_attend` custom VJP over the Pallas kernels, interpret mode)."""
    q, k, v, do = _qkv(dtype, seed=1)
    lens = LENGTHS[lengths]
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_mha(q, k, v, lengths=jlens, interpret=True),
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want = [want, *vjp(jnp.asarray(do).astype(jdt))]
    args = [_torch(x, DTYPES[dtype], grad=True) for x in (q, k, v)]
    tlens = None if lens is None else torch.tensor(lens)
    out, lse = attention.attention_train_op(*args, tlens, 16 ** -0.5)
    assert not lse.requires_grad and lse.dtype == torch.float32
    got = [out, *torch.autograd.grad(out, args, _torch(do, DTYPES[dtype]))]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == DTYPES[dtype], name
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)
    if lens is not None:  # masked keys: exactly zero dK and dV
        assert not got[2][1, 17:].any() and not got[3][1, 17:].any()


@pytest.mark.parametrize("lengths", ["full", "ragged", "with_zero"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_training_op_lse_in_the_kernels_units(dtype, lengths):
    """Natural log for float32, log2 units for bfloat16, against float64;
    a row of length 0 at -1e30 (times log2(e))."""
    q, k, v, _ = (_torch(x, DTYPES[dtype]) for x in _qkv(dtype, seed=2))
    lens = {"full": None, "ragged": torch.tensor([40, 17]),
            "with_zero": torch.tensor([40, 0])}[lengths]
    scale = 16 ** -0.5
    _, lse = attention.attention_train_op(q, k, v, lens, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() * scale, k.double())
    if lens is not None:
        keep = torch.arange(40)[None, :] < lens[:, None]
        s = s.masked_fill(~keep[:, None, None, :], -1e30)
    want = torch.logsumexp(s, -1)
    if dtype == "bf16":
        want = want * attention.LOG2E
    assert lse.shape == (2, 2, 40) and lse.is_contiguous()
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-5)
    if lengths == "with_zero":
        assert torch.all(lse[1] < -1e29)


@pytest.mark.parametrize("kind,b,d", [("mixed", 8, 512), ("mixed", 13, 100),
                                      ("random", 1, 64), ("random", 2, 100)])
def test_loss_op_matches_the_jax_loss_and_gradient(kind, b, d):
    """(loss, dL/dV, dL/dA) for an output gradient of 1 (loss rtol 1e-5,
    atol 1e-6; gradients rtol 1e-4, atol 1e-6), and the op's autograd
    scales them by the output gradient."""
    if kind == "mixed":
        v, a = mixed_activity(b, d, seed=b + d)
    else:
        rng = np.random.default_rng(b)
        v, a = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    jv, ja = jnp.asarray(v), jnp.asarray(a)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda v, a: jax_fused_loss(v, a, 0.2, True), argnums=(0, 1)))(jv, ja)
    tv, ta = (torch.from_numpy(x).requires_grad_() for x in (v, a))
    got = loss.loss_op(tv, ta, 0.2)
    np.testing.assert_allclose(got[0].item(), float(want_loss), rtol=1e-5,
                               atol=1e-6)
    for g, w in zip(got[1:], want):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    scaled = torch.autograd.grad(3.0 * got[0], (tv, ta))
    for g, w in zip(scaled, got[1:]):
        torch.testing.assert_close(g, 3.0 * w, rtol=0, atol=0)


@pytest.fixture(scope="module")
def tower():
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.models.dual_encoder import init_model

    cfg = Config.from_dict({  # the static video tower: the quickest init
        "data": {"target_size": [32, 32], "audio_sample_rate": 800},
        "audio": {"num_layers": 2, "dropout": 0.0},
        "video": {"static": True},
        "training": {"trainer_args": {"precision": 32}}})
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = init_model(cfg, seed=0, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return cfg, model


def test_compiled_tower_and_loss_equal_eager_bit_for_bit(tower):
    """The audio tower in training mode and the loss, compiled whole
    (`aot_eager`, fullgraph): the same loss and gradients bit for bit; the
    forward graph calls the training and loss ops, the backward graph the
    backward op, and no graph holds an `autograd.Function`."""
    from functorch.compile import make_boxed_func
    from torch._dynamo.backends.common import aot_autograd

    from peppa_tpu_torch.ops.loss import triplet_loss

    cfg, model = tower
    gen = torch.Generator().manual_seed(0)
    audio = torch.randn(4, 1840, generator=gen)
    samples = torch.tensor([1840, 1500, 1840, 900])
    video = torch.randn(4, 512, generator=gen)
    params = [p for p in model.audio_encoder.parameters()]

    def block(audio, samples, video):
        a = model.encode_audio(audio, samples, train=True, mask_padding=True)
        return triplet_loss(video, a, cfg.margin)

    graphs = {"dynamo": [], "aot": []}

    def keep(gm, _):
        graphs["aot"].append(gm)
        return make_boxed_func(gm.forward)

    aot = aot_autograd(fw_compiler=keep, bw_compiler=keep)

    def backend(gm, example_inputs):
        graphs["dynamo"].append(gm)
        return aot(gm, example_inputs)

    def run(fn):
        v = video.clone().requires_grad_()
        out = fn(audio, samples, v)
        return [out, *torch.autograd.grad(out, [v] + params)]

    want = run(block)
    torch._dynamo.reset()
    got = run(torch.compile(block, backend=backend, fullgraph=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(graphs["dynamo"]) == 1 and len(graphs["aot"]) == 2

    def targets(gm):
        return [str(n.target) for n in gm.graph.nodes
                if n.op == "call_function"]

    fwd, bwd = (targets(gm) for gm in graphs["aot"])
    layers = cfg.audio.num_layers
    assert fwd.count("peppa_tpu_torch.mha_attention_train.default") == layers
    assert fwd.count("peppa_tpu_torch.fused_triplet_loss.default") == 1
    assert bwd.count("peppa_tpu_torch.mha_attention_bwd.default") == layers
    for gm in graphs["dynamo"] + graphs["aot"]:
        assert not any("autograd_function" in t or "Function" in t
                       for t in targets(gm))


_FIRST_CALLS = r"""
import sys
import torch
from peppa_tpu_torch.ops.cuda.attention import mha_attention
from peppa_tpu_torch.ops.loss import triplet_loss

q, k, v = (torch.randn(2, 8, 2, 16, requires_grad=True) for _ in range(3))
out = mha_attention(q, k, v, torch.tensor([8, 5]))
a = out.mean(dim=(1, 2)).repeat(1, 4)
triplet_loss(torch.randn(2, 64, requires_grad=True), a).backward()
assert q.grad is not None
print(sorted(m for m in sys.modules if m.startswith("torch._dynamo")))
"""


def test_first_calls_of_the_ops_import_no_dynamo():
    """The ops' first forward and backward in a fresh process import no
    `torch._dynamo`: the registration (`torch.library.Library` and
    `register_autograd`) adds nothing to a process's first call."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FIRST_CALLS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
