"""The port's 'model' axis at (1, 2), in two gloo processes
(tests/torch_port_dist_worker.py, job "tp_pair"; rank 0 also runs every
case in one process), against the JAX package under a (1, 2) mesh of the
virtual CPU devices and against the port in one process:

The JAX package's initial variables are carried across with every bias
drawn at random (the inits are zeros).

- `encode_audio` of the split model against the JAX package's under a
  (1, 2) mesh with `param_shardings` applied: float32 within rtol 1e-5
  (atol 1e-7: the embeddings are unit vectors of 512 entries), and of
  the port's one process; bf16 within 2e-3 of the port's one process
  (two bf16 ulps at the embeddings' largest entries, 0.14: the split
  changes the rounding of the row-parallel sums only) and, against the
  JAX package's bf16, each row's cosine within 1e-3 of one process's
  (XLA:CPU keeps the JAX package's bf16 intermediates in float32, so the
  packages' bf16 embeddings differ by up to 4.4e-2 here, split or not);
- int8 eval (`tpu.quantize_int8`) equal to one process bit for bit: the
  row-parallel products take the whole tensors' scales and sum their
  int32 accumulators;
- `replicate_tree`: rank 0's tensors on both ranks;
- BertAdam's clip of a split parameter whose whole gradient's norm is
  above `max_grad_norm` and each slice's below it;
- the default rates (dropout 0.1, layer-drop 0.05) and every rate at 0.1
  (activation dropout on) against one process on the same seed: the
  losses within rel 1e-5, the parameters after the optimizer step within
  1e-3 of each tensor's largest entry plus 1e-3 lr, the video tower's
  update by norm within 10% plus 1e-3 lr
  (tests/test_torch_port_tensor_parallel.py's tolerances);
(tests/test_torch_port_tensor_parallel_serve.py has the checkpoints and
mesh serving.)
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models import dual_encoder as jax_dual_encoder
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from peppa_tpu.parallel.mesh import param_shardings as jax_param_shardings
from peppa_tpu_torch.config import Config

LR = Config().optimizer.lr


def _jax_side(raw, variables, inputs) -> dict:
    out = {"forward": {}}
    mesh = jax_make_mesh((1, 2), ("data", "model"))
    split = jax.device_put(variables, jax_param_shardings(variables, mesh))
    for precision in (32, 16):
        model = JaxPeppaPig(JaxConfig.from_dict(
            dict(raw, training={"trainer_args": {"precision": precision}})))
        with mesh:
            out["forward"][precision] = np.asarray(jax.jit(
                lambda vs, a: model.apply(vs, a, method=model.encode_audio))(
                    split, inputs["waves"]), np.float32)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("tensor_parallel_pair")
    raw = W.tp_raw(str(d / "data"), mesh_shape=(1, 2))
    rng = np.random.default_rng(0)
    grad = rng.normal(size=(8, 4)).astype(np.float32)
    for half in (grad[:4], grad[4:]):
        half *= 0.8 / np.linalg.norm(half)
    inputs = {"raw": raw, "dir": str(d),
              "waves": rng.normal(scale=0.1, size=(2, 8000))
              .astype(np.float32),
              "clip_grad": grad}
    with W.small_transformer(jax_dual_encoder):
        _, variables = jax_init_model(
            JaxConfig.from_dict(raw), jax.random.PRNGKey(0),
            audio_samples=W.SAMPLES, video_frames=W.FRAMES)
        variables = jax.tree.map(np.asarray, variables)
        variables["params"] = _random_biases(variables["params"], rng)
        inputs["variables"] = variables
        W.write_inputs(inputs, str(d))
        pair = W.start_ranks("tp_pair", str(d))
        try:
            jax_out = _jax_side(raw, inputs["variables"], inputs)
        finally:
            pair = W.finish_ranks("tp_pair", pair, str(d))
    return {"inputs": inputs, "jax": jax_out, "pair": pair}


def _random_biases(tree: dict, rng) -> dict:
    """`tree` with every bias drawn from N(0, 0.1^2): the inits are zeros,
    under which a row-parallel bias added once per rank would not show."""
    return {k: (_random_biases(v, rng) if isinstance(v, dict)
                else rng.normal(scale=0.1, size=v.shape).astype(v.dtype)
                if k == "bias" else v)
            for k, v in tree.items()}


def _cosines(a, b):
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("precision", [32, 16])
def test_forward_on_a_1x2_mesh_matches_jax(run, precision):
    r0, r1 = run["pair"]
    got = r0["forward"][precision]
    np.testing.assert_array_equal(r1["forward"][precision]["mesh"],
                                  got["mesh"])
    want = run["jax"]["forward"][precision]
    if precision == 32:
        np.testing.assert_allclose(got["mesh"], want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["mesh"], got["one"], rtol=1e-5,
                                   atol=1e-7)
    else:
        np.testing.assert_allclose(got["mesh"], got["one"], rtol=0,
                                   atol=2e-3)
        # XLA:CPU keeps the JAX package's bf16 intermediates in float32
        # (its bf16 embeddings are within 1.1e-3 of its float32 ones), the
        # port rounds each product to bf16: the split is as close to the
        # JAX package's as one process is
        np.testing.assert_allclose(_cosines(got["mesh"], want),
                                   _cosines(got["one"], want), atol=1e-3)


def test_replicate_tree_puts_rank_0s_tensors_on_every_rank(run):
    for r in run["pair"]:
        a, b = r["replicated"]
        np.testing.assert_array_equal(a, np.zeros(3, np.float32))
        np.testing.assert_array_equal(b, np.arange(4.0, dtype=np.float32))


def test_int8_eval_on_a_1x2_mesh_equals_one_process_bit_for_bit(run):
    r0, r1 = run["pair"]
    np.testing.assert_array_equal(r0["int8"]["mesh"], r0["int8"]["one"])
    np.testing.assert_array_equal(r1["int8"]["mesh"], r0["int8"]["one"])


def test_clip_takes_the_norm_of_the_whole_split_tensor(run):
    grad = run["inputs"]["clip_grad"]
    assert np.linalg.norm(grad) > 1.0  # max_grad_norm
    for r in run["pair"]:
        clip = r["clip"]
        assert clip["slice_norm"] < 1.0
        for got, want in zip(clip["mesh"], run["pair"][0]["clip"]["one"]):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
        # the first moment is 0.1 of the clipped gradient; a clip of each
        # slice alone leaves the gradient as it is
        m_whole, m_slices = clip["mesh"][1], clip["per_slice"][1]
        np.testing.assert_allclose(m_whole, 0.1 * grad
                                   / np.linalg.norm(grad), rtol=1e-5)
        np.testing.assert_allclose(m_slices, 0.1 * grad, rtol=1e-5)


@pytest.mark.parametrize("rates", ["defaults", "rates"])
def test_dropout_and_layer_drop_on_a_1x2_mesh_match_one_process(run, rates):
    r0, r1 = run["pair"]
    assert r1[rates]["mesh"]["losses"] == r0[rates]["mesh"]["losses"]
    got, want = r0[rates]["mesh"], r0[rates]["one"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, w in want["params"].items():
        g = got["params"][k]
        if k.startswith("video_encoder."):
            assert (np.linalg.norm(g - w)
                    <= 0.1 * np.linalg.norm(w - want["start"][k])
                    + 1e-3 * LR), k
        else:
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() \
                + 1e-3 * LR, k
