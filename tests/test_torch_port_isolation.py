"""The port stands alone: no JAX, no flax, nothing of `peppa_tpu`, and no
pandas or cv2 at import (the card's machine has neither); and its entry
points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
for blocked in ("jax", "flax", "pandas", "cv2"):
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
"""


def test_port_imports_no_jax_and_nothing_of_peppa_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


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
