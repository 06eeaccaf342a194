"""The port's whole serving/eval slice against the JAX package, on the CPU.

The base configuration at full width (wav2vec2-base with 2 of its 12
layers, R(2+1)D-18), float32, 32x32 video, 16 kHz audio: the JAX model's
variables are carried across with `load_jax_variables`, then
- the JAX `make_eval_step` and the port's `eval_step` give V and A within
  1e-4 and the loss within rtol 1e-5;
- the JAX `EncoderService` and the port's embed the same mixed-length
  requests over two buckets within 1e-4, and score them alike.
"""

import jax
import numpy as np
import pytest

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.serving import EncoderService as JaxService
from peppa_tpu.training.step import make_eval_step
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training.step import eval_step

TOL = 1e-4
RAW = {
    "data": {"target_size": [32, 32], "audio_sample_rate": 16000},
    "audio": {"num_layers": 2},
    "training": {"trainer_args": {"precision": 32}},
    "tpu": {"bucket_durations": [0.1, 0.2]},
}


@pytest.fixture(scope="module")
def models():
    jax_cfg = JaxConfig.from_dict(RAW)
    cfg = Config.from_dict(RAW)
    assert cfg.to_dict() == jax_cfg.to_dict()
    jax_model, variables = jax_init_model(jax_cfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    port = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(port, variables)
    return jax_cfg, jax_model, variables, cfg, port


def test_eval_step_matches_jax(models):
    jax_cfg, jax_model, variables, cfg, port = models
    rng = np.random.default_rng(0)
    b = 4
    video = rng.integers(0, 256, size=(b, 8, 32, 32, 3)).astype(np.uint8)
    audio = rng.normal(scale=0.1, size=(b, 3200)).astype(np.float32)
    frames = np.array([8, 5, 8, 3], np.int32)
    samples = np.array([3200, 2000, 3100, 1200], np.int32)
    dur = np.full((b,), 0.2, np.float32)
    jv, ja, jloss = make_eval_step(jax_model)(variables, JaxClipBatch(
        video=video, audio=audio, video_duration=dur, audio_duration=dur,
        video_frames=frames, audio_samples=samples))
    v, a, loss = eval_step(port, ClipBatch(
        video=video, audio=audio, video_duration=dur, audio_duration=dur,
        video_frames=frames, audio_samples=samples), device="cpu")
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_encoder_service_matches_jax(models):
    jax_cfg, jax_model, variables, cfg, port = models
    rng = np.random.default_rng(1)
    # 16 kHz: buckets of 1600 and 3200 samples; 40 fps: of 4 and 8 frames
    waves = [rng.normal(scale=0.1, size=(s,)).astype(np.float32)
             for s in (1200, 1600, 3200, 2500, 900, 4000)]
    clips = [rng.uniform(size=(t, 32, 32, 3)).astype(np.float32)
             for t in (3, 8, 4, 6, 10)]
    jsvc = JaxService(jax_model, variables, jax_cfg, batch_size=3, fps=40.0)
    svc = EncoderService(port, cfg, batch_size=3, fps=40.0, device="cpu")
    a = svc.embed_audio(waves)
    v = svc.embed_video(clips)
    assert a.shape == (6, 512) and v.shape == (5, 512)
    np.testing.assert_allclose(a, jsvc.embed_audio(waves), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(v, jsvc.embed_video(clips), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(svc.similarity(v, a), jsvc.similarity(v, a),
                               rtol=TOL, atol=TOL)
    svc.warmup()  # every (bucket, batch) shape runs
