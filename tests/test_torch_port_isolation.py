"""The port stands alone: no JAX, no flax, no msgpack, nothing of
`peppa_tpu`, and no pandas or cv2 at import (the card's machine has both,
but the port imports them, and the analysis layer's scipy, sklearn,
matplotlib and Levenshtein, only inside the functions that use them); and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
for blocked in ("jax", "flax", "msgpack", "pandas", "cv2"):
    sys.modules[blocked] = None  # any import of these now fails
import peppa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(peppa_tpu_torch.__path__,
                                               "peppa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "peppa_tpu" or m.startswith("peppa_tpu."))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 30, names
assert "peppa_tpu_torch.ablation_sweep" in names, names
"""


def test_port_imports_no_jax_and_nothing_of_peppa_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


_HOST_PROBE = r"""
import importlib, pkgutil, sys
blocked = ("pandas", "scipy", "sklearn", "matplotlib", "Levenshtein",
           "sentence_transformers", "spacy", "jinja2")
for name in blocked:
    sys.modules[name] = None  # any import of these now fails
import peppa_tpu_torch
for m in pkgutil.walk_packages(peppa_tpu_torch.__path__, "peppa_tpu_torch."):
    importlib.import_module(m.name)
from peppa_tpu_torch.analysis import grsa, ols, plotting, stats  # noqa
print(sorted(b for b in blocked if sys.modules.get(b) is not None))
"""


def test_analysis_host_packages_are_imported_inside_functions():
    """The results path imports its host packages (pandas, scipy, sklearn,
    matplotlib, Levenshtein, sentence-transformers, spaCy, jinja2) only in
    the functions that use them: every port module imports with all of
    them blocked (the card's machine lacks some)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _HOST_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from peppa_tpu_torch.config import Config
    from peppa_tpu_torch.models.dual_encoder import init_model
    from peppa_tpu_torch.serving import EncoderService
    from peppa_tpu_torch.training.step import eval_step
    from peppa_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.audio.num_layers = 1
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncoderService(torch.nn.Linear(1, 1), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_step(torch.nn.Linear(1, 1), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_evaluation_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The evaluation entry: `load_best_model`, `make_predict`
    and both CLIs default to the card and raise without it, before they
    read anything."""
    from peppa_tpu_torch import evaluate, targeted_eval
    from peppa_tpu_torch.evaluation.evaluation import make_predict
    from peppa_tpu_torch.training.checkpoint import load_best_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: load_best_model(str(tmp_path)),
                 lambda: make_predict(torch.nn.Linear(1, 1)),
                 lambda: evaluate.main(["--versions", "0", "--log_dir",
                                        str(tmp_path)]),
                 lambda: targeted_eval.main(["--run", "--versions", "0",
                                             "--log_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


_DEPLOY_PROBE = r"""
import sys
for blocked in ("jax", "flax", "msgpack"):
    sys.modules[blocked] = None  # any import of these now fails
import peppa_tpu_torch.example, peppa_tpu_torch.export  # noqa: E401, F401
print(sorted(m for m in sys.modules
             if m == "peppa_tpu" or m.startswith("peppa_tpu.")))
"""


def test_deployment_modules_import_no_jax():
    """`export.py` and `example.py` import nothing of JAX or of the JAX
    package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DEPLOY_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_deployment_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The artifact loader, the export CLI unless it is asked for the CPU
    alone, and the example default to the card and raise without it,
    before they read anything."""
    from peppa_tpu_torch import example, export

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runs = str(tmp_path / "runs")
    for call in (lambda: export.ExportedEncoders(str(tmp_path)),
                 lambda: export.main([runs, str(tmp_path / "out")]),
                 lambda: export.main([runs, str(tmp_path / "out"),
                                      "--platforms", "cuda", "cpu"]),
                 lambda: export.main([runs, "--reference_ckpt",
                                      str(tmp_path / "ref.ckpt")]),
                 lambda: example.main(runs, str(tmp_path / "*.wav"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert os.listdir(tmp_path) == []


RESULTS_ENTRY_POINTS = {
    "duration_effect": lambda ev, g, d, kw: ev.duration_effect(d),
    "duration_effect_scramble":
        lambda ev, g, d, kw: ev.duration_effect_scramble(d),
    "grsa.Embedder.embed": lambda ev, g, d, kw: g.Embedder(0, **kw).embed(),
    "grsa.pairwise": lambda ev, g, d, kw: g.pairwise(0, **kw),
    "grsa.embed_utterances": lambda ev, g, d, kw: g.embed_utterances(0, **kw),
    "grsa.unpairwise": lambda ev, g, d, kw: g.unpairwise(0, **kw),
    "grsa.main": lambda ev, g, d, kw: g.main([0], **kw),
    "grsa CLI": lambda ev, g, d, kw: g.cli(["--log_dir", kw["log_dir"],
                                            "--data_dir", d]),
}


@pytest.mark.parametrize("name", list(RESULTS_ENTRY_POINTS))
def test_results_entry_points_raise_without_cuda(monkeypatch, tmp_path,
                                                 name):
    """The results path's entry points that run a model default to the
    card and raise without it, before they read anything (`tmp_path`
    holds no conditions.yaml, run directory or realign tree)."""
    from peppa_tpu_torch.analysis import grsa
    from peppa_tpu_torch.evaluation import evaluation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    kw = dict(log_dir=str(tmp_path / "runs"), data_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RESULTS_ENTRY_POINTS[name](evaluation, grsa, str(tmp_path), kw)
    assert os.listdir(tmp_path) == []


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card chip_smoke exits non-zero and prints no result; so it
    does in a directory that holds nothing else of the repository."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert here.returncode != 0
    assert '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_ALIGN_PROBE = r"""
import sys
for blocked in ("jax", "flax", "pandas", "cv2"):
    sys.modules[blocked] = None
import numpy as np
from peppa_tpu_torch.preprocess import forced_align as F
tokens, _ = F.text_to_tokens("hi mum")
lp = np.log(np.full((20, len(F.CTC_CHARS)), 1.0 / len(F.CTC_CHARS)))
F.ctc_forced_align(lp, tokens)
with open("/proc/self/maps") as f:
    libs = sorted({line.split()[-1] for line in f if "ctc_align" in line})
print(libs)
"""


def test_aligner_loads_the_ports_own_native_library():
    """The forced aligner's DP is the port's build of
    `native/src/ctc_align.cpp` under `peppa_tpu_torch/_build/`, never the
    JAX package's `peppa_tpu/native/libpeppa_ctc_align.so`."""
    from peppa_tpu_torch.native.build import BUILD_ROOT

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ALIGN_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    libs = eval(out.stdout.strip().splitlines()[-1])
    assert len(libs) == 1 and libs[0].startswith(BUILD_ROOT + os.sep), libs


def test_aligner_raises_without_cuda(monkeypatch, tmp_path):
    """`make_ctc_logits_fn` defaults to the card and raises without it,
    before it reads the checkpoint it is given."""
    from peppa_tpu_torch.preprocess.forced_align import make_ctc_logits_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({"checkpoint_path": str(tmp_path / "absent.pt")},
               {"variables": {"params": {}}}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_ctc_logits_fn(**kw)


_TF32_PROBE = r"""
import torch
from peppa_tpu_torch.preprocess import forced_align  # noqa: F401
from peppa_tpu_torch.analysis import grsa  # noqa: F401
print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
"""


def test_float32_paths_pin_tf32_off():
    """A fresh process that imports the aligner and the GRSA embedder has
    both TF32 flags off: cuDNN's (PyTorch's default is on) and the
    matmul's.  The flags read and set without CUDA."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _TF32_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["False", "False"], out.stdout
