"""`PigData` over an extracted episode tree, against the JAX package's: the
train batches of both loaders (native and Python) and of the iterable
path, the validation and test loaders, the statistics pass, and
`TripletScorer` on carried-across weights; a `Trainer.fit` over the native
path preempted and resumed equals an unbroken run tensor for tensor; the
CLI trains over a tree without `--synthetic_data`.

Small sizes: 32x24 frames, 800 Hz audio, 7 s clips; wav2vec2-base with 2
of its 12 layers, float32.  Batches compare exactly; embeddings within
1e-4 (the towers' tolerance), triplet scores within 1e-6.
"""

import os
import random
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.datamodule import PigData as JaxPigData
from peppa_tpu.data.stats import load_stats as jax_load_stats
from peppa_tpu.data.synthetic import \
    make_synthetic_episode_tree as jax_make_tree
from peppa_tpu.evaluation.evaluation import make_predict
from peppa_tpu.evaluation.triplet import TripletScorer as JaxTripletScorer
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import PigData
from peppa_tpu_torch.data.stats import load_stats
from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
from peppa_tpu_torch.evaluation.triplet import TripletScorer
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.dual_encoder import init_model
import peppa_tpu_torch.training.loop as L
from peppa_tpu_torch.utils.profiling import counters
from test_torch_port_trainer import (_drop_checkpoints,  # noqa: F401
                                     _init_once, _two_threads,
                                     assert_same_state, losses, rows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODES = {"dialog": (1, 2, 3, 197, 198), "narration": (1, 2, 105)}
RAW = {
    "data": {"target_size": [32, 24], "audio_sample_rate": 800,
             "num_workers": 3,
             "train": {"batch_size": 4, "duration": 0.8, "jitter": True,
                       "jitter_sd": 0.5, "shuffle": True},
             "val": {"batch_size": 4, "duration": 0.8},
             "test": {"batch_size": 4, "duration": 2.0}},
    "audio": {"num_layers": 2},
    "training": {"trainer_args": {"precision": 32,
                                  "accumulate_grad_batches": 2},
                 "max_epochs": 1, "num_sanity_val_steps": 0,
                 "limit_train_batches": 3, "limit_val_batches": 1,
                 "log_every_n_steps": 1},
    "optimizer": {"t_total": 100},
    "tpu": {"bucket_durations": [0.8, 2.0], "mesh_shape": [1, 1],
            "donate_state": False},
}
TOL = 1e-4
FIELDS = ("video", "audio", "video_duration", "audio_duration",
          "video_frames", "audio_samples")


def _tree(root, make=make_synthetic_episode_tree):
    for fragment, episodes in EPISODES.items():
        make(str(root), target_size=(32, 24), fragment_type=fragment,
             episodes=episodes, clips_per_episode=2, clip_seconds=7.0,
             sample_rate=800, seed=1, correlated=True)
    return str(root)


def _configs(port_dir, jax_dir, **tpu):
    cfg, jax_cfg = Config.from_dict(RAW), JaxConfig.from_dict(RAW)
    cfg.data.data_dir, jax_cfg.data.data_dir = port_dir, jax_dir
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
        setattr(jax_cfg.tpu, k, v)
    return cfg, jax_cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree written by each package (equal: test_torch_port_data)."""
    return (_tree(tmp_path_factory.mktemp("port")),
            _tree(tmp_path_factory.mktemp("jax"), jax_make_tree))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in FIELDS:
            gv, wv = np.asarray(getattr(g, k)), np.asarray(getattr(w, k))
            assert gv.dtype == wv.dtype, k
            np.testing.assert_array_equal(gv, wv, err_msg=k)
    return got


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "i16"])
def test_train_batches_equal_jax(trees, int16):
    """Both packages' native loaders over their own caches and packs, and
    the port's Python loader, give the same batches for each epoch."""
    cfg, jax_cfg = _configs(*trees, pack_audio_int16=int16)
    port, ref = PigData(cfg), JaxPigData(jax_cfg)
    random.seed(0)  # the jitter of the cache build
    port.setup()
    random.seed(0)
    ref.setup()
    assert port.train.cache_dir.endswith(
        os.path.basename(ref.train.cache_dir))
    served = counters()["NativeBatchLoader.served"]
    for epoch in (0, 1):
        got = _same_batches(port.train_batches(epoch),
                            ref.train_batches(epoch))
        assert all(isinstance(b.video, torch.Tensor) for b in got)
    n = counters()["NativeBatchLoader.served"] - served
    assert n == 2 * len(got) and n > 0
    pack = "items_i16.pack" if int16 else "items.pack"
    assert os.path.exists(os.path.join(port.train.cache_dir, pack))
    if not int16:  # the Python loader reads the cache's float32 audio
        cfg.tpu.native_loader = False
        for epoch in (0, 1):
            _same_batches(port.train_batches(epoch), ref.train_batches(epoch))
        assert counters()["NativeBatchLoader.served"] - served == n


def test_iterable_train_batches_equal_jax(trees):
    cfg, jax_cfg = _configs(*trees)
    cfg.data.iterable = jax_cfg.data.iterable = True
    port, ref = PigData(cfg), JaxPigData(jax_cfg)
    port.setup()
    ref.setup()
    random.seed(3)
    got = list(port.train_batches(0))
    random.seed(3)
    _same_batches(got, ref.train_batches(0))


def test_val_and_test_loaders_equal_jax(trees):
    cfg, jax_cfg = _configs(*trees)
    port, ref = PigData(cfg), JaxPigData(jax_cfg)
    port.setup()
    ref.setup()
    assert len(port.val_dia) == 32 and len(port.val_narr3) == 12
    for g, w in zip(port.val_loaders(), ref.val_loaders()):
        _same_batches(g, w)
    _same_batches(port.test_loader("narration"),
                  ref.test_loader("narration"))


def test_prepare_data_equals_jax(tmp_path):
    cfg, jax_cfg = _configs(_tree(tmp_path / "port"),
                            _tree(tmp_path / "jax", jax_make_tree))
    cfg.data.prepare = jax_cfg.data.prepare = True
    random.seed(1)
    PigData(cfg).prepare_data()
    random.seed(1)
    JaxPigData(jax_cfg).prepare_data()
    got = load_stats(os.path.join(cfg.data.data_dir, "out", "stats.npz"))
    want = jax_load_stats(os.path.join(jax_cfg.data.data_dir, "out",
                                       "stats.npz"))
    for k in ("video_mean", "video_std", "audio_mean", "audio_std"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    # extraction reads data/in, which this tree lacks: both packages fail
    # at the episode list (tests/test_torch_port_extract.py extracts one)
    cfg.data.extract = jax_cfg.data.extract = True
    for data in (PigData(cfg), JaxPigData(jax_cfg)):
        with pytest.raises(FileNotFoundError,
                           match="peppa_pig_dataset-video_list.csv"):
            data.prepare_data()


def test_triplet_scorer_equals_jax(trees):
    """The dialog val lines encoded by each package's model on the same
    weights: embeddings within 1e-4, the same accuracies within 1e-6."""
    cfg, jax_cfg = _configs(*trees)
    jax_model, variables = jax_init_model(jax_cfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    port = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(port, variables)
    kw = dict(fragment_type="dialog", split=["val"], target_size=(32, 24),
              audio_sample_rate=800)
    want_scorer = JaxTripletScorer(data_dir=trees[1], **kw)
    want = want_scorer.evaluate(make_predict(jax_model, variables),
                                batch_size=4, n_samples=50, seed=3)
    scorer = TripletScorer(data_dir=trees[0], **kw)
    got = scorer.evaluate(port, batch_size=4, n_samples=50, seed=3,
                          device="cpu")
    np.testing.assert_allclose(scorer._video.numpy(), want_scorer._video,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(scorer._audio.numpy(), want_scorer._audio,
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(scorer._duration, want_scorer._duration)
    assert got["accuracy"].shape == want["accuracy"].shape == (50,)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
    np.testing.assert_array_equal(got["duration"], want["duration"])
    # a callable on numpy batches, as the JAX package takes one
    again = scorer.evaluate(
        lambda b: port(b.to("cpu"), train=False), batch_size=4,
        n_samples=50, seed=3)
    np.testing.assert_array_equal(again["accuracy"], got["accuracy"])


# ------------------------------------------------------- resume over PigData
RESUME_KW = dict(limit_train_batches=3, max_epochs=2)


def _fit(tmp_path, tag, data_dir, resume_from=None, data_cls=PigData,
         **training):
    cfg = Config.from_dict(RAW)
    cfg.data.data_dir = data_dir
    for k, v in {**RESUME_KW, **training}.items():
        setattr(cfg.training, k, v)
    if data_cls is not PigData:
        cfg.tpu.prefetch = 0  # batches made in step with the loop
    trainer = L.Trainer(cfg, log_dir=str(tmp_path / tag), device="cpu")
    state = trainer.fit(data_cls(cfg), resume_from=resume_from)
    return trainer, state


class PreemptedAtStep5(PigData):
    """Sends SIGUSR1 while the loop takes micro-step 5's batch."""

    def train_batches(self, epoch=0):
        for i, b in enumerate(super().train_batches(epoch)):
            if epoch == 1 and i == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            yield b


def test_resume_over_pigdata_is_bit_identical(tmp_path):
    """2 epochs of 3 micro-steps over the native loader, k=2, unbroken;
    then preempted inside the second epoch and resumed: the later losses and
    the final state equal the unbroken run's, tensor for tensor."""
    data_dir = _tree(tmp_path / "data")
    served = counters()["NativeBatchLoader.served"]
    straight, s_state = _fit(tmp_path, "straight", data_dir)
    assert counters()["NativeBatchLoader.served"] - served >= 6
    want = losses(straight.version_dir)
    partial, _ = _fit(tmp_path, "partial", data_dir,
                      data_cls=PreemptedAtStep5)
    assert partial.preempted
    ckpt = os.path.join(partial.version_dir, "checkpoints", "preempted.ckpt")
    resumed, r_state = _fit(tmp_path, "resumed", data_dir, resume_from=ckpt)
    got = losses(resumed.version_dir)
    assert sorted(got) == [6]
    assert got[6] == want[6]
    assert_same_state(r_state, s_state)


def test_cli_trains_over_an_episode_tree(tmp_path):
    """`python -m peppa_tpu_torch.run` without `--synthetic_data` builds the
    item caches and the pack and trains through the native loader."""
    data_dir = _tree(tmp_path / "data")
    cfg = Config.from_dict(RAW)
    cfg.data.data_dir = data_dir
    cfg.training.limit_val_batches = 1
    config_file = str(tmp_path / "tiny.yaml")
    with open(config_file, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    log_dir = str(tmp_path / "logs")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, "-m", "peppa_tpu_torch.run", "--device", "cpu",
         "--config_file", config_file, "--log_dir", log_dir,
         "--limit_train_batches", "2", "--max_epochs", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Native loader: " in out.stderr
    caches = sorted(d for d in os.listdir(os.path.join(data_dir, "out"))
                    if d.startswith("items-"))
    assert len(caches) == 5  # train, two fixed val sets, two line sets
    train = [d for d in caches if d.startswith("items-train-")]
    assert len(train) == 1
    assert os.path.exists(os.path.join(data_dir, "out", train[0],
                                       "items.pack"))
    steps = [int(r["step"]) for r in rows(os.path.join(log_dir, "version_0"))
             if r.get("train_loss")]
    assert steps == [1, 2]
