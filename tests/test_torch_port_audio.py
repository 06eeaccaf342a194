"""The port's wav2vec2 audio tower against the JAX package's, on the CPU.

The JAX `Wav2Vec2Encoder` at a tiny width (embed 32, 2 layers, 4 heads,
pos-conv k=16 g=4), float32, is carried across with `load_jax_variables`;
every tap, the int16 input path and `mask_padding=True` must agree within
1e-4 (the towers' tolerance of PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from peppa_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

TINY = dict(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64, num_out=28,
            pos_conv_kernel=16, pos_conv_groups=4, layer_drop=0.0)
TOL = 1e-4


@pytest.fixture(scope="module")
def towers():
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(2, 3200)).astype(np.float32)
    jax_enc = JaxEncoder(full=True, pooling="attention", project=True,
                         cfg=JaxW2VConfig(**TINY))
    variables = jax_enc.init(jax.random.PRNGKey(0), jnp.asarray(audio))
    variables = jax.tree.map(np.asarray, variables)
    # non-trivial scales and biases (1-d leaves), so a swapped leaf shows
    variables = jax.tree.map(
        lambda x: x + rng.normal(scale=0.1, size=x.shape).astype(x.dtype)
        if x.ndim == 1 else x, variables)
    port = Wav2Vec2Encoder(full=True, pooling="attention", project=True,
                           cfg=Wav2Vec2Config(**TINY))
    load_jax_variables(port, variables)
    return jax_enc, variables, port.eval()


@pytest.mark.parametrize("tap", ["conv", "context", "logits", "pooled",
                                 "embedding"])
def test_taps_match_jax(towers, tap):
    jax_enc, variables, port = towers
    audio = np.random.default_rng(1).normal(size=(2, 3200)).astype(np.float32)
    want = np.asarray(jax_enc.apply(variables, jnp.asarray(audio), tap=tap))
    with torch.inference_mode():
        got = port(torch.from_numpy(audio), tap=tap).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_int16_input_matches_jax(towers):
    jax_enc, variables, port = towers
    audio = np.random.default_rng(2).integers(
        -20000, 20000, size=(2, 3200)).astype(np.int16)
    want = np.asarray(jax_enc.apply(variables, jnp.asarray(audio)))
    with torch.inference_mode():
        got = port(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_mask_padding_matches_jax(towers):
    jax_enc, variables, port = towers
    audio = np.random.default_rng(3).normal(size=(2, 3200)).astype(np.float32)
    lengths = np.array([3200, 1900], np.int32)
    audio[1, 1900:] = 0.0
    want = np.asarray(jax_enc.apply(variables, jnp.asarray(audio),
                                    jnp.asarray(lengths), mask_padding=True))
    with torch.inference_mode():
        got = port(torch.from_numpy(audio), torch.from_numpy(lengths),
                   mask_padding=True).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the mask must matter: row 1 differs from its unmasked embedding
    with torch.inference_mode():
        unmasked = port(torch.from_numpy(audio)).numpy()
    assert np.abs(unmasked[1] - got[1]).max() > 1e-3


def test_dropout_path_not_ported_yet(towers):
    """The dropout path, refused before the training slice, now runs: it
    draws from the generator it is given (same seed, same output), differs
    from the deterministic forward, and needs a generator."""
    _, _, port = towers
    audio = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3200)).astype(np.float32))
    run = lambda seed: port(audio, deterministic=False,
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))
        assert not torch.allclose(run(1), port(audio), atol=1e-3)
        with pytest.raises(ValueError, match="Generator"):
            port(audio, deterministic=False)
