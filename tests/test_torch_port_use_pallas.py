"""`tpu.use_pallas: false` routes the port's attention as it routes the JAX
package's: scores, a -inf mask, softmax, PV, and never the attention
kernel's wrapper.

The JAX package, on the CPU, takes its XLA route whatever the flag says
(its Pallas kernel runs only on a TPU), so the two packages are compared
under the flag at 1e-5 (float32, wav2vec2-base with 2 of its 12 layers,
carried-across weights), with and without key masking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models import wav2vec2
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from test_torch_port_convert import _two_threads  # noqa: F401

TOL = 1e-5
RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 16000},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}},
       "tpu": {"use_pallas": False}}


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxConfig.from_dict(RAW), Config.from_dict(RAW)
    assert cfg.tpu.use_pallas is False and jcfg.tpu.use_pallas is False
    jmodel, variables = jax_init_model(jcfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    port = PeppaPig(cfg).eval()
    load_jax_variables(port, variables)
    return jmodel, variables, port


def _spy(monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        raise AssertionError("mha_attention called under use_pallas: false")
    monkeypatch.setattr(wav2vec2, "mha_attention", spy)
    return calls


@pytest.mark.parametrize("tap,mask", [("embedding", False),
                                      ("context", False),
                                      ("context", True)])
def test_plain_route_matches_jax(models, monkeypatch, tap, mask):
    jmodel, variables, port = models
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(0)
    audio = rng.normal(scale=0.1, size=(3, 4000)).astype(np.float32)
    samples = np.array([4000, 2500, 1200], np.int32)
    want = jmodel.apply(variables, jnp.asarray(audio), jnp.asarray(samples),
                        tap=tap, mask_padding=mask,
                        method=jmodel.encode_audio)
    with torch.inference_mode():
        got = port.encode_audio(torch.from_numpy(audio),
                                torch.from_numpy(samples), tap=tap,
                                mask_padding=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert calls == []


def test_plain_route_in_training_draws_dropout(models, monkeypatch):
    """Training under the flag keeps the plain route and its dropout on the
    probabilities; deterministic forwards apply none."""
    _, _, port = models
    calls = _spy(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        scale=0.1, size=(2, 3200)).astype(np.float32))
    attn = port.audio_encoder.wav2vec2.layer0.attention
    assert attn.use_pallas is False
    with torch.no_grad():
        a = port.encode_audio(x, tap="context")
        b = port.encode_audio(x, tap="context")
        c = port.encode_audio(x, tap="context", train=True,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert calls == []


def test_flag_on_takes_the_kernel_wrapper(monkeypatch):
    """The default (`use_pallas: true`) still goes through the wrapper, 12
    calls per encode at full depth, 2 here."""
    cfg = Config.from_dict({**RAW, "tpu": {"use_pallas": True}})
    port = PeppaPig(cfg).eval()
    calls = []
    real = wav2vec2.mha_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(wav2vec2, "mha_attention", spy)
    with torch.inference_mode():
        port.encode_audio(torch.zeros(1, 3200))
    assert len(calls) == 2
