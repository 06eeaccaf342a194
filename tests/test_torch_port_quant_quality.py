"""`python -m peppa_tpu_torch.quant_quality` on the CPU, against what
scripts/quant_quality.py computes: the JAX package's `run_validation` of
the same weights (carried across) on the same synthetic validation
batches.

Small sizes: 32x32 frames, 800 Hz audio, wav2vec2-base with 1 of its 12
layers, the static video tower (ResNet-18 on each frame: the quickest to
compile on the JAX side), float32, 12 clips a validation set; the port's seeded
weights carried to the JAX package.  The float row is held as
tests/test_torch_port_validation.py holds `run_validation`: the losses
within rtol 1e-5, the triplet accuracies equal, and the recalls within 3
bootstrap standard errors of the two means (the JAX package draws its
subsets with `jax.random.permutation`, the port with torch).  The int8
row is what the port's `run_validation` returned for the run's weights
with `tpu.quantize_int8` on (a spy records each call's model and row).
"""

import os

import jax
import numpy as np
import pytest
import torch

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.datamodule import SyntheticPigData as JaxPigData
from peppa_tpu.evaluation.validation import \
    run_validation as jax_run_validation
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.training.step import make_eval_step
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data.datamodule import SyntheticPigData
from peppa_tpu_torch.evaluation import validation
from peppa_tpu_torch.models.convert import export_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig, init_model
from peppa_tpu_torch.ops.metrics import resampled_recall
from peppa_tpu_torch.quant_quality import quant_quality
from peppa_tpu_torch.training import checkpoint as C
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.utils.profiling import counters
from test_torch_port_trainer import _two_threads  # noqa: F401

RAW = {
    "data": {"target_size": [32, 32], "audio_sample_rate": 800,
             "val": {"batch_size": 12}},  # one batch a fixed set
    "audio": {"num_layers": 1},
    "video": {"static": True},
    "training": {"trainer_args": {"precision": 32}},
}
N_VAL = 12
SAMPLES = 500  # the script's bootstrap subsets


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """The port's gate over a run directory of seeded weights, each
    `run_validation` call it made (the model's flag, its weights, the
    row), and the JAX package's validation of the same weights."""
    tmp = tmp_path_factory.mktemp("quant_quality")
    raw = {**RAW, "data": {**RAW["data"], "data_dir": str(tmp / "data")}}
    jax_cfg, cfg = JaxConfig.from_dict(raw), Config.from_dict(raw)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as `_two_threads` does for each test
    calls = []
    real = validation.run_validation

    def spy(model, *args, **kw):
        row = real(model, *args, **kw)
        calls.append((model.config.tpu.quantize_int8,
                      {k: v.clone() for k, v in model.state_dict().items()},
                      row))
        return row

    try:
        model = init_model(cfg, seed=0, device="cpu")
        vdir = str(tmp / "version_0")
        os.makedirs(os.path.join(vdir, "checkpoints"))
        cfg.dump(os.path.join(vdir, "hparams.yaml"))
        path = os.path.join(vdir, "checkpoints",
                            "epoch=0-valnarr_triplet=0.50.ckpt")
        C.save_checkpoint(path, TrainState.create(model, cfg), {
            "monitor": "valnarr_triplet", "mode": "max",
            "best_model_score": 0.5, "best_model_path": path, "epoch": 0,
            "metrics": {}})
        validation.run_validation = spy
        got = quant_quality(vdir, n_val=N_VAL, device="cpu")
    finally:
        validation.run_validation = real
        torch.set_num_threads(threads)
    jax_data = JaxPigData(jax_cfg, n_val=N_VAL)
    jax_data.setup()
    want = jax_run_validation(make_eval_step(JaxPeppaPig(jax_cfg)),
                              export_jax_variables(model),
                              jax_data.val_loaders(), n_samples=SAMPLES)
    data = SyntheticPigData(cfg, n_val=N_VAL)
    data.setup()
    return {"got": got, "want": want, "model": model, "calls": calls,
            "data": data, "path": path}


def test_float_row_matches_the_jax_validation(gate):
    got, want = gate["got"]["float"], gate["want"]
    assert set(got) == set(want)
    for k in ("val_loss", "valnarr_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("val_triplet", "valnarr_triplet"):
        assert got[k] == want[k], k
    loaders = gate["data"].val_loaders()
    for k, loader in (("val_rec_fixed", loaders[0]),
                      ("valnarr_rec_fixed", loaders[1])):
        enc = validation.encode_loader(gate["model"], loader, "cpu")
        per = resampled_recall(enc["video"], enc["audio"], 0, size=N_VAL,
                               n_samples=SAMPLES, n=10).numpy()
        se = per.std() / np.sqrt(len(per))
        assert se > 0
        assert abs(got[k] - want[k]) <= 3 * np.sqrt(2) * se, k


def test_int8_row_is_the_int8_validation(gate):
    """Two validations over the run's weights, int8 off and then on; the
    rows are theirs, and the int8 model runs int8 products."""
    weights = gate["model"].state_dict()
    assert [c[0] for c in gate["calls"]] == [False, True]
    for _, state, _ in gate["calls"]:
        assert state.keys() == weights.keys()
        assert all(torch.equal(state[k], weights[k]) for k in weights)
    assert gate["calls"][0][2] == gate["got"]["float"]
    assert gate["calls"][1][2] == gate["got"]["int8"]
    assert gate["got"]["int8"] != gate["got"]["float"]
    cfg = Config.from_dict(gate["model"].config.to_dict())
    cfg.tpu.quantize_int8 = True
    before = counters()["int8_matmul.calls"]
    with torch.inference_mode():
        PeppaPig(cfg).eval().encode_audio(torch.zeros(1, 1840))
    assert counters()["int8_matmul.calls"] > before


def test_printed_rows_and_deltas(gate, capsys):
    """The script's lines, from the returned rows: the checkpoint, the
    synthetic label, both rows and one delta a key."""
    from peppa_tpu_torch import quant_quality as module

    vdir = os.path.dirname(os.path.dirname(gate["path"]))
    real = validation.run_validation
    rows = iter([gate["got"]["float"], gate["got"]["int8"]])
    try:  # the rows computed above, printed again
        validation.run_validation = lambda *a, **kw: next(rows)
        module.main([vdir, str(N_VAL), "--device", "cpu"])
    finally:
        validation.run_validation = real
    lines = capsys.readouterr().out.splitlines()
    got = gate["got"]
    assert lines[0] == f"checkpoint: {gate['path']}"
    assert lines[1].startswith(f"data: SYNTHETIC val corpus (n_val={N_VAL})")
    assert lines[2] == "float " + str({k: round(v, 4)
                                       for k, v in got["float"].items()})
    assert lines[3] == "int8 " + str({k: round(v, 4)
                                      for k, v in got["int8"].items()})
    assert lines[4] == "deltas (int8 - float):"
    assert lines[5:] == [f"  {k}: {got['int8'][k] - got['float'][k]:+.4f}"
                         for k in got["float"]]
