"""The port's R(2+1)D-18 video tower against the JAX package's, on the CPU.

R(2+1)D-18 at 32x32, 8 frames, B=2, float32, with `midplanes_multiple`
None and 128, with and without `frame_lengths`; weights (and non-trivial
BatchNorm statistics) carried across with `load_jax_variables`.  Within
1e-4 (the towers' tolerance of PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peppa_tpu.models.video3d import R3DEncoder as JaxR3D
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.video3d import R3DEncoder, midplanes

TOL = 1e-4


def _perturbed(variables, rng):
    """Non-trivial BatchNorm statistics, scales and biases (1-d leaves)."""
    def bump(path, x):
        if x.ndim != 1:
            return x
        if path[-1].key == "var":
            return x + rng.uniform(0.5, 1.5, size=x.shape).astype(x.dtype)
        return x + rng.normal(scale=0.1, size=x.shape).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(bump, variables)


@pytest.fixture(scope="module", params=[None, 128], ids=["paper", "x128"])
def towers(request):
    rng = np.random.default_rng(0)
    kw = dict(version="r2plus1d_18", pooling="attention", project=True,
              midplanes_multiple=request.param)
    jax_enc = JaxR3D(**kw)
    video = jnp.zeros((1, 8, 32, 32, 3), jnp.float32)
    variables = jax.tree.map(
        np.asarray, jax.jit(jax_enc.init)(jax.random.PRNGKey(0), video))
    variables = _perturbed(variables, rng)
    port = R3DEncoder(**kw)
    load_jax_variables(port, variables)
    return jax_enc, variables, port.eval()


@pytest.mark.parametrize("lengths", [None, (8, 3)], ids=["full", "ragged"])
def test_embedding_matches_jax(towers, lengths):
    jax_enc, variables, port = towers
    video = np.random.default_rng(1).integers(
        0, 256, size=(2, 8, 32, 32, 3)).astype(np.uint8)
    lens = np.asarray(lengths, np.int32) if lengths else None
    want = np.asarray(jax_enc.apply(
        variables, jnp.asarray(video),
        jnp.asarray(lens) if lens is not None else None))
    with torch.inference_mode():
        got = port(torch.from_numpy(video),
                   torch.from_numpy(lens) if lens is not None else None).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_features_match_jax(towers):
    """The trunk's channels-last features, float [0, 1] input."""
    jax_enc, variables, port = towers
    video = np.random.default_rng(2).uniform(
        size=(2, 8, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_enc.apply(variables, jnp.asarray(video),
                                    tap="features"))
    with torch.inference_mode():
        got = port(torch.from_numpy(video), tap="features").numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=TOL, atol=TOL)


def test_midplanes_matches_jax():
    from peppa_tpu.models.video3d import midplanes as jax_midplanes

    for c_in, c_out in [(3, 64), (64, 64), (64, 128), (128, 256), (256, 512)]:
        for multiple in (None, 64, 128):
            assert (midplanes(c_in, c_out, multiple)
                    == jax_midplanes(c_in, c_out, multiple))


def test_train_mode_not_ported_yet(towers):
    """Train mode, refused before the training slice, now runs: BatchNorm on
    batch statistics, running statistics updated as the JAX module's
    `mutable=["batch_stats"]` apply updates them."""
    jax_enc, variables, port = towers
    video = np.random.default_rng(4).integers(
        0, 256, size=(2, 8, 32, 32, 3)).astype(np.uint8)
    want, mut = jax_enc.apply(variables, jnp.asarray(video), None, True,
                              mutable=["batch_stats"])
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(video), train=True).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
        stats = jax.tree_util.tree_flatten_with_path(mut["batch_stats"])[0]
        for path, x in stats:
            keys = [k.key for k in path if k.key != "bn"]
            name = ".".join(keys[:-1] + [{"mean": "running_mean",
                                          "var": "running_var"}[keys[-1]]])
            np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                       np.asarray(x), rtol=TOL, atol=TOL,
                                       err_msg=name)
    finally:
        port.load_state_dict(saved)
