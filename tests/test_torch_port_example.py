"""The port's minimal "embed audio" API (`peppa_tpu_torch/example.py`)
against the root example.py, on the CPU.

A run directory of the JAX package's format (hparams.yaml and scored flax
msgpack checkpoints) of the tiny 2-layer test config, and a few 44.1 kHz
WAV files of different lengths (one padded batch).  The port's
`example.main` embeds them as the port's own `encode_audio` does, bit for
bit, and as the JAX package's `example.main` does within 1e-4 (its compile
of the 2-layer encoder takes about 15 s here, so the case is not marked
slow).
"""

import json
import os
import wave

import numpy as np
import torch

from peppa_tpu_torch import example
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.audio import audio_files, collate_audio
from peppa_tpu_torch.models.convert import export_jax_variables
from peppa_tpu_torch.models.dual_encoder import init_model
from peppa_tpu_torch.training.flax_msgpack import write_checkpoint

RAW = {"data": {"target_size": [32, 32]}, "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}}}
TOL = 1e-4
SECONDS = (0.21, 0.15, 0.3, 0.21)


def _write_wav(path, seconds, rate=44100, seed=0):
    rng = np.random.default_rng(seed)
    samples = (np.clip(rng.standard_normal(int(rate * seconds)) * 0.1, -1, 1)
               * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


def _wavs(root):
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    for i, sec in enumerate(SECONDS):
        _write_wav(wav_dir / f"{i}.wav", sec, seed=i)
    return str(wav_dir / "*.wav")


def _write_run(vdir, cfg, scores_and_variables):
    """hparams.yaml and one msgpack checkpoint (with its sidecar) per
    (score, variables)."""
    os.makedirs(os.path.join(vdir, "checkpoints"))
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    for epoch, (score, variables) in enumerate(scores_and_variables):
        path = os.path.join(vdir, "checkpoints",
                            f"epoch={epoch}-valnarr_triplet={score:.2f}.ckpt")
        write_checkpoint(path, {"step": np.asarray(0, np.int32),
                                **variables, "opt_state": {}})
        with open(path + ".json", "w") as f:
            json.dump({"monitor": "valnarr_triplet", "mode": "max",
                       "best_model_score": score, "best_model_path": path,
                       "epoch": epoch, "metrics": {}}, f)


def test_example_embeds_as_the_ports_encoder(tmp_path, capsys):
    """The best of two checkpoints, the files in sorted order, one padded
    batch: the port's own `encode_audio` bit for bit."""
    torch.set_num_threads(2)
    cfg = Config.from_dict(RAW)
    best = init_model(cfg, seed=0, device="cpu")
    worse = init_model(cfg, seed=1, device="cpu")
    vdir = str(tmp_path / "version_0")
    _write_run(vdir, cfg, [(0.1, export_jax_variables(worse)),
                           (0.5, export_jax_variables(best))])
    audio_glob = _wavs(tmp_path)
    emb = example.main(vdir, audio_glob, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "Audio embedding tensor with shape: (4, 512)"
    from glob import glob
    batch = collate_audio(list(audio_files(sorted(glob(audio_glob)))))
    with torch.inference_mode():
        want = best.encode_audio(torch.from_numpy(batch)).numpy()
    assert np.array_equal(emb, want)
    assert np.abs(emb[0] - emb[3]).max() > 1e-6  # distinct inputs


def test_example_matches_jax_example(tmp_path):
    import jax

    import example as jax_example
    from peppa_tpu.config import Config as JaxConfig
    from peppa_tpu.models.dual_encoder import init_model as jax_init_model

    torch.set_num_threads(2)
    _, variables = jax_init_model(JaxConfig.from_dict(RAW),
                                  jax.random.PRNGKey(0), audio_samples=3200,
                                  video_frames=4)
    variables = jax.tree.map(np.asarray, variables)
    vdir = str(tmp_path / "version_0")
    _write_run(vdir, Config.from_dict(RAW), [(0.5, variables)])
    audio_glob = _wavs(tmp_path)
    want = jax_example.main(vdir, audio_glob)
    got = example.main(vdir, audio_glob, device="cpu")
    assert got.shape == want.shape == (len(SECONDS), 512)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
