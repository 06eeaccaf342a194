"""One JAX-format run directory over a realign tree, and the random inits
of the GRSA analysis carried across from the JAX package, for
`tests/test_torch_port_grsa*.py`.

- The run: a float32 model (32x24 frames, 800 Hz, wav2vec2-base with 2 of
  its 12 layers, the static video tower) with seeded weights, saved by the JAX package's
  `save_checkpoint` (flax msgpack and its sidecar) beside hparams.yaml.
- The inits: `grsa` draws its untrained and average-pooled models from
  `init_model(cfg, PRNGKey(1|2))` in the JAX package and `init_model(cfg,
  seed=1|2)` in the port, whose draws differ.  Both are replaced by the
  JAX package's audio tower at that key: flax derives each submodule's
  key from its path, so `PeppaPig.init(..., method=encode_audio)` gives
  the same audio parameters as the whole model's init, in a fraction of
  its compile time.  The port's model takes them through
  `load_jax_variables`; its video tower, which no GRSA stage reads, keeps
  the port's init.  Each init is drawn once per test module and copied.
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import peppa_tpu.models.dual_encoder as JD
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.training import checkpoint as JC
from peppa_tpu_torch.analysis import grsa
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models import dual_encoder as D
from peppa_tpu_torch.models.convert import (export_jax_variables,
                                            load_jax_variables)
from test_torch_port_convert import _random
from torch_port_realign_data import write_realign_tree

# the static (2-D ResNet-18) video tower: no GRSA stage reads the video
# tower, and it is the smaller one to initialise, save and load
RAW = {"data": {"target_size": [32, 24], "audio_sample_rate": 800},
       "audio": {"num_layers": 2}, "video": {"static": True},
       "training": {"trainer_args": {"precision": 32}}}
TOL = 1e-4
_AUDIO_INITS = {}
_PORT_INITS = {}
# (audio.pooling, audio.project, audio.pretrained, seed) of each call of
# the port's init by `grsa`, in order
INIT_CALLS = []


def _structure(cfg_dict):
    """The config without the keys that do not change the parameters."""
    audio = {k: v for k, v in cfg_dict["audio"].items() if k != "pretrained"}
    return json.dumps({**cfg_dict, "audio": audio}, sort_keys=True)


def jax_audio_init(jcfg, rng):
    """The JAX package's audio-tower variables of `init_model(jcfg, rng)`."""
    key = (_structure(jcfg.to_dict()), np.asarray(rng).tobytes())
    if key not in _AUDIO_INITS:
        model = JD.PeppaPig(jcfg)
        params, dropout, layerdrop = jax.random.split(rng, 3)
        _AUDIO_INITS[key] = jax.tree.map(np.asarray, jax.jit(
            lambda r, x: model.init(r, x, method=model.encode_audio))(
                {"params": params, "dropout": dropout,
                 "layerdrop": layerdrop}, jnp.zeros((1, 6400), jnp.float32)))
    return _AUDIO_INITS[key]


def patch_inits(mp):
    """Both packages' `init_model`, as `grsa` reaches them, replaced by the
    JAX package's audio init (module doc)."""
    def jax_init(cfg, rng, *args, **kw):
        return JD.PeppaPig(cfg), jax_audio_init(cfg, rng)

    def port_init(cfg, seed=0, device=None):
        INIT_CALLS.append((cfg.audio.pooling, cfg.audio.project,
                           cfg.audio.pretrained, seed))
        key = (_structure(cfg.to_dict()), seed)
        if key not in _PORT_INITS:
            model = D.init_model(cfg, seed=seed, device="cpu")
            tree = export_jax_variables(model)
            audio = jax_audio_init(JaxConfig.from_dict(cfg.to_dict()),
                                   jax.random.PRNGKey(seed))
            tree["params"]["audio_encoder"] = \
                audio["params"]["audio_encoder"]
            load_jax_variables(model, tree)
            _PORT_INITS[key] = model
        return copy.deepcopy(_PORT_INITS[key]).to(device)

    mp.setattr(JD, "init_model", jax_init)
    mp.setattr(grsa, "init_model", port_init)


def make_run(root, per_episode=2):
    """The realign tree under root/data and the run directory
    root/runs/version_0; returns (data_dir, log_dir, cfg)."""
    data_dir = os.path.join(root, "data")
    write_realign_tree(data_dir, seed=0, per_episode=per_episode)
    cfg = Config.from_dict(RAW)
    log_dir = os.path.join(root, "runs")
    write_jax_run(os.path.join(log_dir, "version_0"),
                  _random(D.PeppaPig(cfg), seed=1), cfg)
    return data_dir, log_dir, cfg


def write_jax_run(vdir, model, cfg):
    """A JAX-format run directory holding `model`: hparams.yaml and one
    checkpoint written by the JAX package's `save_checkpoint`."""
    tree = export_jax_variables(model)
    os.makedirs(os.path.join(vdir, "checkpoints"))
    cfg.dump(os.path.join(vdir, "hparams.yaml"))
    params = jax.tree.map(jnp.asarray, tree["params"])
    state = SimpleNamespace(
        step=jnp.asarray(1, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
        opt_state=optax.sgd(1e-4).init(params))
    path = os.path.join(vdir, "checkpoints",
                        "epoch=0-valnarr_triplet=0.50.ckpt")
    JC.save_checkpoint(path, state, {
        "monitor": "valnarr_triplet", "mode": "max",
        "best_model_score": 0.5, "best_model_path": path, "epoch": 0,
        "metrics": {}})


@pytest.fixture(scope="module")
def grsa_run(tmp_path_factory):
    """make_run under a module temporary directory, with patch_inits for
    the module; the checkpoint is deleted at the end."""
    import torch

    from test_torch_port_convert import remove_large_files

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("grsa")
    with pytest.MonkeyPatch.context() as mp:
        patch_inits(mp)
        data_dir, log_dir, cfg = make_run(str(root))
        yield {"root": root, "data_dir": data_dir, "log_dir": log_dir,
               "cfg": cfg}
    remove_large_files(root)
    torch.set_num_threads(before)
