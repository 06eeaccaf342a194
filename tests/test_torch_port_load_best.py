"""`load_best_model` and `EncoderService.from_checkpoint` over the three
kinds of run directory: the port's (torch.save zip with a `.ckpt.json`
sidecar), the JAX package's (flax msgpack with a sidecar, written by the
JAX package's `save_checkpoint`) and the reference's (Lightning files with
no sidecar, written by the JAX package's `save_reference_checkpoint`).

Each directory holds a better and a worse checkpoint of different
weights.  The port picks the JAX package's best file; the loaded weights
are the source's exactly; the embeddings are the JAX package's within 1e-4
(float32).  The format is decided per file: a port directory is never read
as Lightning.

Small sizes: 32x24 frames, 800 Hz audio, wav2vec2-base with 2 of its 12
layers, float32.
"""

import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import peppa_tpu.models.convert as J
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.types import ClipBatch as JaxClipBatch
from peppa_tpu.evaluation.evaluation import make_predict as jax_make_predict
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.training import checkpoint as JC
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.models import convert as P
from peppa_tpu_torch.models.dual_encoder import PeppaPig
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training import checkpoint as C
from peppa_tpu_torch.training.state import TrainState
from test_torch_port_convert import (_drop_large_files,  # noqa: F401
                                     _random, _two_threads,
                                     assert_trees_equal, remove_large_files)

RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 2},
       "training": {"trainer_args": {"precision": 32}}}
TOL = 1e-4
BEST, WORSE = ("valnarr_triplet", 0.75), ("valnarr_rec_fixed", 0.25)


def _batch():
    rng = np.random.default_rng(0)
    return dict(
        video=rng.integers(0, 256, size=(2, 8, 24, 32, 3), dtype=np.uint8),
        audio=rng.normal(size=(2, 1840)).astype(np.float32),
        video_duration=np.full((2,), 0.8, np.float32),
        audio_duration=np.full((2,), 2.3, np.float32),
        video_frames=np.array([8, 6], np.int32),
        audio_samples=np.array([1840, 1500], np.int32))


def _meta(monitor, score, path):
    return {"monitor": monitor, "mode": "max", "best_model_score": score,
            "best_model_path": path, "epoch": 0, "metrics": {}}


def _ckpt(vdir, monitor, score):
    return os.path.join(vdir, "checkpoints",
                        f"epoch=0-{monitor}={score:.2f}.ckpt")


def _write_port(vdir, models, cfg):
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    for model, (monitor, score) in zip(models, (BEST, WORSE)):
        path = _ckpt(vdir, monitor, score)
        C.save_checkpoint(path, TrainState.create(model, cfg),
                          _meta(monitor, score, path))


def _write_jax(vdir, trees, cfg):
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    for tree, (monitor, score) in zip(trees, (BEST, WORSE)):
        params = jax.tree.map(jnp.asarray, tree["params"])
        state = SimpleNamespace(
            step=jnp.asarray(3, jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
            opt_state=optax.sgd(1e-4).init(params))  # no state to store
        path = _ckpt(vdir, monitor, score)
        JC.save_checkpoint(path, state, _meta(monitor, score, path))


def _write_lightning(vdir, trees, jcfg, hparams):
    if hparams:
        with open(os.path.join(vdir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(jcfg.to_dict(), f)
    for tree, (monitor, score) in zip(trees, (BEST, WORSE)):
        path = _ckpt(vdir, monitor, score)
        J.save_reference_checkpoint(path, tree, jcfg, monitor=monitor,
                                    score=score)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two weight sets (best, worse) written into one run directory of
    each kind, and the JAX package's embeddings of the best."""
    torch.set_num_threads(2)
    cfg, jcfg = Config.from_dict(RAW), JaxConfig.from_dict(RAW)
    models = [_random(PeppaPig(cfg), seed) for seed in (1, 2)]
    trees = [P.export_jax_variables(m) for m in models]
    root = tmp_path_factory.mktemp("runs")
    dirs = {kind: str(root / kind / "version_0")
            for kind in ("port", "jax", "lightning", "lightning_embedded")}
    for d in dirs.values():
        os.makedirs(os.path.join(d, "checkpoints"))
    _write_port(dirs["port"], models, cfg)
    _write_jax(dirs["jax"], trees, cfg)
    _write_lightning(dirs["lightning"], trees, jcfg, hparams=True)
    # the same files, linked, in a directory without hparams.yaml
    for name in os.listdir(os.path.join(dirs["lightning"], "checkpoints")):
        os.link(os.path.join(dirs["lightning"], "checkpoints", name),
                os.path.join(dirs["lightning_embedded"], "checkpoints", name))
    out = jax_make_predict(JaxPeppaPig(jcfg), trees[0])(
        JaxClipBatch(**_batch()))
    want = (np.asarray(out.video), np.asarray(out.audio))
    yield {"dirs": dirs, "trees": trees, "cfg": cfg, "jcfg": jcfg,
           "want": want}
    remove_large_files(root)


@pytest.mark.parametrize("kind", ["port", "jax", "lightning"])
def test_load_best_model_reads_every_kind(runs, kind):
    vdir = runs["dirs"][kind]
    model, config, path = C.load_best_model(vdir, device="cpu")
    assert path == _ckpt(vdir, *BEST)
    # the JAX package picks the same file (its reader, for its own formats)
    if kind == "lightning":
        want_path, _ = JC.best_torch_checkpoint_in(vdir)
    else:
        want_path, _ = JC.best_checkpoint_in(vdir)
    assert want_path == path
    assert config.audio.num_layers == 2
    assert not model.training
    assert_trees_equal(P.export_jax_variables(model), runs["trees"][0])
    with torch.inference_mode():
        out = model(ClipBatch(**_batch()).to("cpu"))
    np.testing.assert_allclose(out.video.numpy(), runs["want"][0],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.audio.numpy(), runs["want"][1],
                               rtol=TOL, atol=TOL)


def test_jax_load_best_model_reads_the_same_msgpack_variables(runs):
    """The JAX package's own `load_best_model` of its directory gives the
    variables the port loaded (its Lightning import needs a JAX init, and
    tests/test_checkpoint_import.py holds it)."""
    _, variables, _, path = JC.load_best_model(runs["dirs"]["jax"])
    assert path == _ckpt(runs["dirs"]["jax"], *BEST)
    assert_trees_equal(jax.tree.map(np.asarray, variables), runs["trees"][0])


def test_lightning_without_hparams_uses_embedded_config(runs, monkeypatch):
    """No hparams.yaml: the embedded hyper_parameters (the reference's
    keys, so 12 audio layers, of which the file holds 2) give the config;
    the recorded best_model_path's local file is the one read."""
    import peppa_tpu_torch.models.dual_encoder as dual_encoder

    monkeypatch.setattr(dual_encoder, "init_model",
                        lambda config, seed=0, device=None: PeppaPig(config))
    vdir = runs["dirs"]["lightning_embedded"]
    model, config, path = C.load_best_model(vdir, device="cpu")
    assert path == _ckpt(vdir, *BEST)
    assert config.audio.num_layers is None
    assert config.data.target_size == (32, 24)
    got = P.export_jax_variables(model)["params"]
    assert_trees_equal(got["video_encoder"],
                       runs["trees"][0]["params"]["video_encoder"])


def test_best_model_path_prefers_the_local_file(runs, tmp_path):
    """A Lightning file records where it was written; in a copied run
    directory the same-named local file is read."""
    vdir = str(tmp_path / "version_3")
    shutil.copytree(runs["dirs"]["lightning"], vdir, copy_function=os.link)
    path, meta = C.best_torch_checkpoint_in(vdir)
    assert path == _ckpt(vdir, *BEST)
    assert meta["best_model_path"] == _ckpt(runs["dirs"]["lightning"], *BEST)
    assert (path, meta["best_model_score"]) == (
        JC.best_torch_checkpoint_in(vdir)[0], 0.75)


def test_formats_are_decided_per_file(runs, tmp_path, monkeypatch):
    d = runs["dirs"]
    assert C.checkpoint_format(_ckpt(d["port"], *BEST)) == "port"
    assert C.checkpoint_format(_ckpt(d["jax"], *BEST)) == "jax"
    assert C.checkpoint_format(_ckpt(d["lightning"], *BEST)) == "lightning"
    bare = str(tmp_path / "bare.ckpt")  # msgpack without its sidecar
    os.link(_ckpt(d["jax"], *BEST), bare)
    assert C.checkpoint_format(bare) == "jax"
    # a legacy (pre-zip) torch pickle without a sidecar is Lightning's
    legacy = str(tmp_path / "legacy.ckpt")
    torch.save({"state_dict": {}}, legacy,
               _use_new_zipfile_serialization=False)
    assert C.checkpoint_format(legacy) == "lightning"
    assert C._is_torch_checkpoint(legacy) == JC._is_torch_checkpoint(legacy)
    # a port directory with no scored checkpoint is not read as Lightning
    vdir = tmp_path / "version_9"
    shutil.copytree(d["port"], vdir, copy_function=os.link)
    for p in (vdir / "checkpoints").glob("*.ckpt.json"):
        meta = json.loads(p.read_text())
        meta["best_model_score"] = None
        p.unlink()  # a link to the fixture's sidecar: write a new file
        p.write_text(json.dumps(meta))

    def refuse(path):
        raise AssertionError(f"{path} read as a Lightning checkpoint")

    monkeypatch.setattr(P, "load_torch_checkpoint", refuse)
    with pytest.raises(FileNotFoundError, match="No scored torch"):
        C.load_best_model(str(vdir), device="cpu")


@pytest.mark.parametrize("kind", ["port", "jax", "lightning"])
def test_encoder_service_serves_every_kind(runs, kind):
    svc = EncoderService.from_checkpoint(runs["dirs"][kind], device="cpu",
                                         buckets=(2.3,))
    b = _batch()
    got = svc.embed_audio([b["audio"][0], b["audio"][1][:1500]])
    with torch.inference_mode():
        want = svc.model.encode_audio(torch.from_numpy(
            np.stack([b["audio"][0], np.pad(b["audio"][1][:1500],
                                             (0, 340))]))).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_trees_equal(P.export_jax_variables(svc.model), runs["trees"][0])
