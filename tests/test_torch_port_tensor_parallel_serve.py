"""A checkpoint written on the port's 'model' axis and resumed on other
meshes, and mesh serving, in two gloo processes
(tests/torch_port_dist_worker.py, job "tp_serve"; rank 0 also runs each
case in one process):

- a checkpoint written at (1, 2) inside an accumulation group (micro-step
  3 of k = 2) and resumed at (2, 1) and at (1, 1): the next two losses
  within rel 1e-5 of the straight run's (the whole tensors gathered and
  sliced again; the (2, 1) run splits the buffer over its data rows);
- `EncoderService(mesh=...)` at (2, 1): the same embeddings on both
  ranks, one process's within 1e-5 (each rank encodes 2 of a batch's 4
  rows), the JAX service's on a (2, 1) mesh of the virtual CPU devices
  within 1e-4 (tests/test_torch_port_slice.py's), and the JAX package's
  `batch_size` error.
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.models import dual_encoder as jax_dual_encoder
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from peppa_tpu.serving import EncoderService as JaxService
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.parallel.mesh import Mesh
from peppa_tpu_torch.serving import EncoderService


def _requests(rng) -> dict:
    """Audio and video requests over both buckets (0.8 and 2.0 s at
    1600 Hz and 10 fps), 5 of each: two batches of 4 rows each."""
    return {
        "audio": [rng.normal(scale=0.1, size=n).astype(np.float32)
                  for n in (600, 1280, 2000, 3200, 900)],
        "video": [rng.integers(0, 256, size=(t, 32, 32, 3)).astype(np.uint8)
                  for t in (5, 8, 12, 20, 3)]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("tensor_parallel_serve")
    raw = W.tp_raw(str(d / "data"), mesh_shape=(2, 1))
    requests = _requests(np.random.default_rng(0))
    with W.small_transformer(jax_dual_encoder):
        model, variables = jax_init_model(
            JaxConfig.from_dict(raw), jax.random.PRNGKey(0),
            audio_samples=W.SAMPLES, video_frames=W.FRAMES)
        variables = jax.tree.map(np.asarray, variables)
        W.write_inputs({"raw": raw, "dir": str(d), "variables": variables,
                        "requests": requests}, str(d))
        ranks = W.start_ranks("tp_serve", str(d))
        try:
            svc = JaxService(model, variables, JaxConfig.from_dict(raw),
                             batch_size=4,
                             mesh=jax_make_mesh((2, 1), ("data", "model")))
            jax_out = {"audio": svc.embed_audio(requests["audio"]),
                       "video": svc.embed_video(requests["video"])}
        finally:
            ranks = W.finish_ranks("tp_serve", ranks, str(d))
    return {"jax": jax_out, "ranks": ranks}


def test_checkpoint_written_at_1x2_resumes_at_2x1_and_1x1(run):
    s0, s1 = run["ranks"]
    straight = s0["next_losses"]
    assert s1["next_losses"] == straight
    assert s0["resumed"]["mesh"] == s1["resumed"]["mesh"]
    np.testing.assert_allclose(s0["resumed"]["mesh"], straight, rtol=1e-5)
    np.testing.assert_allclose(s0["resumed"]["one"], straight, rtol=1e-5)


def test_serving_over_a_2x1_mesh_matches_one_process_and_jax(run):
    s0, s1 = run["ranks"]
    for kind in ("audio", "video"):
        got = s0["served"]["mesh"][kind]
        assert got.shape == (5, 512)
        np.testing.assert_array_equal(s1["served"]["mesh"][kind], got)
        np.testing.assert_allclose(got, s0["served"]["one"][kind], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, run["jax"][kind], rtol=1e-4,
                                   atol=1e-4)


def test_serving_refuses_a_batch_size_that_does_not_divide_over_data():
    mesh = Mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match=r"batch_size 3 must divide over "
                       r"the mesh's data axis \(2\)"):
        EncoderService(torch.nn.Linear(1, 1), Config(), batch_size=3,
                       device="cpu", mesh=mesh)
