"""The port's bench (`peppa_tpu_torch/bench.py`) against the JAX package's
root bench.py, on the CPU.

- `_build_bench_pack` writes the JAX script's bytes, v1 (float32 audio)
  and v2 (int16); `_drop_file_cache` evicts a fresh file;
- `encode_score` on the tiny configuration of test_torch_port_slice.py
  (2 transformer layers, 32x32 video, 16 kHz, float32: kernel 1's plain
  version on the path), the port's seeded weights carried across to the
  JAX model (`export_jax_variables`: no JAX init to compile), one
  perturbed batch: V and A within 1e-4 of the JAX expression
  (bench.py's `one_batch`), the loss within rtol 1e-5, the recalls equal,
  the scalar within rtol 1e-4;
- `host_fed_pairs_per_sec` has the JAX host-fed test's distribution for
  the f32, int16 and cold variants (tests/test_bench_hostfed.py's tiny
  model);
- `train_throughput` and `main` give the JAX script's keys; the FLOP count
  adds the attention op's formula to `FlopCounterMode`'s count;
- every entry point raises without CUDA unless it is given the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.ops.loss import triplet_loss as jax_triplet_loss
from peppa_tpu.ops.metrics import recall_at_n as jax_recall_at_n
from peppa_tpu_torch import bench
from peppa_tpu_torch.config import Config, default_config
from peppa_tpu_torch.models.convert import export_jax_variables
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.models.wav2vec2 import conv_output_length
from peppa_tpu_torch.native.loader import NativePack

TOL = 1e-4
RAW = {  # tests/test_torch_port_slice.py's tiny configuration
    "data": {"target_size": [32, 32], "audio_sample_rate": 16000},
    "audio": {"num_layers": 2},
    "training": {"trainer_args": {"precision": 32}},
    "tpu": {"bucket_durations": [0.1, 0.2]},
}
LINE_KEYS = {  # bench.py's line (:216-229) with the card's own numbers
    "metric", "value", "unit", "vs_baseline", "pct_of_chip_peak",
    "pct_assumes", "chip_peak_tflops_band", "model_tflop_per_pair",
    "host_fed_pairs_per_sec", "host_fed", "train_clips_per_sec",
    "train_step_ms", "train_recipe", "device", "encode_peak_memory_gib",
    "train_peak_memory_gib"}


@pytest.fixture(scope="module")
def models():
    jax_cfg = JaxConfig.from_dict(RAW)
    cfg = Config.from_dict(RAW)
    assert cfg.to_dict() == jax_cfg.to_dict()
    port = init_model(cfg, seed=0, device="cpu")
    return (jax_cfg, JaxPeppaPig(jax_cfg), export_jax_variables(port), cfg,
            port)


@pytest.fixture
def tiny_config(monkeypatch):
    """`bench.default_config` gives the tiny configuration."""
    monkeypatch.setattr(bench, "default_config",
                        lambda: Config.from_dict(RAW))


@pytest.mark.parametrize("audio_int16", [False, True])
def test_bench_pack_is_the_jax_bytes(tmp_path, audio_int16):
    mine, theirs = tmp_path / "port.ppkc", tmp_path / "jax.ppkc"
    assert bench._build_bench_pack(str(mine), 8, 4, 3200,
                                   audio_int16=audio_int16) == 8
    jax_bench._build_bench_pack(str(theirs), 8, 4, 3200,
                                audio_int16=audio_int16)
    assert mine.read_bytes() == theirs.read_bytes()
    assert NativePack(str(mine)).version == (2 if audio_int16 else 1)


def test_drop_file_cache(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(np.random.default_rng(0).bytes(1 << 20))
    assert bench._drop_file_cache(str(p)) is True


def test_encode_score_matches_the_jax_expression(models):
    jax_cfg, jax_model, variables, cfg, port = models
    rng = np.random.default_rng(3)
    b, frames, samples = 12, 8, 3200  # recall@10 over 12 rows
    base_video = rng.integers(0, 256, (b, frames, 32, 32, 3), np.uint8)
    base_audio = (rng.standard_normal((b, samples)) * 0.1).astype(np.float32)
    vbyte, ascale = np.uint8(173), np.float32(1.0 + 7e-4)

    @jax.jit
    def one_batch(vs, video, audio):  # bench.py:88-104
        batch = JaxClipBatch(
            video=jnp.bitwise_xor(video, vbyte), audio=audio * ascale,
            video_duration=jnp.full((b,), 2.3),
            audio_duration=jnp.full((b,), 2.3),
            video_frames=jnp.full((b,), frames, jnp.int32),
            audio_samples=jnp.full((b,), samples, jnp.int32))
        out = jax_model.apply(vs, batch, train=False)
        loss = jax_triplet_loss(out.video, out.audio, margin=jax_cfg.margin)
        rec = jax_recall_at_n(out.video, out.audio, jnp.eye(b), n=10)
        return (out.video, out.audio, loss, rec, jnp.sum(out.video)
                + jnp.sum(out.audio) + loss + jnp.sum(rec))

    jv, ja, jloss, jrec, jscalar = (np.asarray(x) for x in one_batch(
        variables, base_video, base_audio))
    batch = bench.perturbed(torch.from_numpy(base_video),
                            torch.from_numpy(base_audio),
                            torch.tensor(vbyte), torch.tensor(ascale))
    with torch.inference_mode():
        v, a, loss, rec = bench.encode_score_terms(port, batch, cfg.margin)
        scalar = bench.encode_score(port, batch, cfg.margin)
    np.testing.assert_allclose(v.numpy(), jv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a.numpy(), ja, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(rec.numpy(), jrec)
    assert 0 < jrec.mean() < 1  # the recalls tell the rows apart
    np.testing.assert_allclose(float(scalar), float(jscalar), rtol=TOL)


def test_perturbation_draws_a_byte_and_a_scale_near_one():
    gen = torch.Generator().manual_seed(5)
    draws = [bench.draw_perturbation(gen) for _ in range(64)]
    assert all(v.dtype == torch.uint8 and v.ndim == 0 for v, _ in draws)
    assert len({int(v) for v, _ in draws}) > 32
    scales = np.array([float(s) for _, s in draws])
    assert np.all(np.abs(scales - 1.0) <= 1e-3) and np.ptp(scales) > 1e-3
    video = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 16, 16, 1)
    audio = torch.ones((1, 8))
    out = bench.perturbed(video, audio, *draws[0])
    assert sorted(out.video.flatten().tolist()) == list(range(256))
    assert torch.equal(out.audio, audio * draws[0][1])
    assert out.video_frames.tolist() == [1] and out.audio_samples.tolist() \
        == [8]


@pytest.fixture(scope="module")
def hostfed_model():
    """tests/test_bench_hostfed.py's tiny model: the conv-only audio
    trunk, float32, 180x100 video (a pack's frames)."""
    cfg = default_config()
    cfg.data.target_size = (180, 100)
    cfg.training.precision = "fp32"
    cfg.audio.full = False
    return init_model(cfg, seed=0, device="cpu"), cfg, 4, 3200


def _host_fed(hostfed_model, tmp_path, monkeypatch, name, **kw):
    model, cfg, frames, samples = hostfed_model
    monkeypatch.setenv("BENCH_HOST_BATCH", "4")
    monkeypatch.setenv("BENCH_HOST_ITEMS", "8")
    monkeypatch.setenv("BENCH_HOST_WINDOWS", "3")
    monkeypatch.setenv("BENCH_HOST_WINDOW_SECONDS", "0.3")
    monkeypatch.setenv("BENCH_PACK", str(tmp_path / f"{name}.ppkc"))
    return bench.host_fed_pairs_per_sec(model, cfg, frames, samples,
                                        device="cpu", **kw)


def test_host_fed_distribution_and_variants(hostfed_model, tmp_path,
                                            monkeypatch):
    """tests/test_bench_hostfed.py:44-63 on the port."""
    stats = _host_fed(hostfed_model, tmp_path, monkeypatch, "f32")
    assert set(stats) == {"median", "min", "max", "windows", "window_seconds"}
    assert len(stats["windows"]) == 3
    assert stats["min"] <= stats["median"] <= stats["max"]
    assert stats["min"] > 0
    assert sorted(stats["windows"])[1] == stats["median"]

    i16 = _host_fed(hostfed_model, tmp_path, monkeypatch, "i16",
                    audio_int16=True)
    assert i16["median"] > 0
    pack = NativePack(str(tmp_path / "i16.ppkc"))
    assert np.dtype(pack.audio_dtype) == np.int16
    pack.close()

    cold = _host_fed(hostfed_model, tmp_path, monkeypatch, "cold",
                     cold_cache=True)
    assert set(cold) == set(stats) | {"first_pass_cold"}
    assert cold["first_pass_cold"] > 0


def test_host_fed_probe_times_the_loader_alone(hostfed_model, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("BENCH_HOST_WINDOW_SECONDS", "0.05")
    rate = _host_fed(hostfed_model, tmp_path, monkeypatch, "probe",
                     probe=True)
    assert rate > 0


def test_train_throughput_keys(tiny_config, monkeypatch):
    losses = []
    real = bench.train_step

    def spy(*a, **kw):
        state, metrics = real(*a, **kw)
        losses.append(float(metrics["train_loss"]))
        return state, metrics

    monkeypatch.setattr(bench, "train_step", spy)
    out = bench.train_throughput(8, 3200, micro_b=2, accum=2,
                                 warmup_steps=1, timed_steps=2, device="cpu")
    assert set(out) == {"train_clips_per_sec", "train_step_ms",
                        "train_recipe"}
    assert out["train_recipe"] == jax_bench.TRAIN_RECIPE
    assert out["train_clips_per_sec"] > 0 and out["train_step_ms"] > 0
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    with pytest.raises(ValueError, match="accumulation cycles"):
        bench.train_throughput(8, 3200, accum=4, timed_steps=6,
                               device="cpu")


def test_main_prints_one_json_line_with_the_jax_keys(tiny_config,
                                                     monkeypatch, capsys):
    for name, value in (("BENCH_TRAIN", "0"), ("BENCH_HOST_FED", "0"),
                        ("BENCH_BATCH", "2"), ("BENCH_K", "1"),
                        ("BENCH_REPEATS", "1")):
        monkeypatch.setenv(name, value)
    line = bench.main(device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == LINE_KEYS
    assert line["vs_baseline"] is None
    assert line["metric"] == "clip_pairs_per_sec_per_chip_encode_score"
    assert line["value"] > 0 and line["model_tflop_per_pair"] > 0
    # the CPU has no card: none of the card's numbers
    assert line["device"] == {"name": None, "power_limit_w": None}
    assert line["pct_of_chip_peak"] is None
    assert line["chip_peak_tflops_band"] == [None, 989.0]
    assert line["encode_peak_memory_gib"] is None
    assert line["host_fed"] == {} and line["host_fed_pairs_per_sec"] is None
    assert line["train_recipe"] is None


def test_flop_count_adds_the_attention_formula(models):
    """The counter has no formula for the attention op: the count is
    FlopCounterMode's plus 4 T^2 hd per head and layer."""
    from torch.utils.flop_counter import FlopCounterMode

    _, _, _, cfg, port = models
    frames, samples = bench.clip_shape(cfg)
    total = bench.model_flops_per_pair(port, cfg, frames, samples)
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        port.encode_video(torch.zeros((1, frames, 32, 32, 3),
                                      dtype=torch.uint8))
        port.encode_audio(torch.zeros((1, samples)))
    t = conv_output_length(samples)
    assert total == counter.get_total_flops() + 2 * 12 * 4 * t * t * 64
    assert counter.get_total_flops() > 0


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from peppa_tpu_torch import serving_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_PACK", str(tmp_path / "absent.ppkc"))
    for call in (bench.main,
                 lambda: bench.train_throughput(8, 3200),
                 lambda: bench.host_fed_pairs_per_sec(None, None, 4, 3200),
                 lambda: serving_bench.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert list(tmp_path.iterdir()) == []
