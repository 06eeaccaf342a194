"""Build and load the port's CUDA kernels.

Each source in `peppa_tpu_torch/csrc/` is compiled by `nvcc` for sm_90a
into its own shared library with a plain C interface, loaded with `ctypes`
(no PyTorch headers, so a build takes seconds).  The build runs at first
use, all sources at once (one `nvcc` each, started together), into
`peppa_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and the
flags; a later call in the same or another process reuses it.  A failed
build raises with the compiler's output.

`nvcc` is taken from `$CUDA_HOME/bin`, else from `PATH`, else from
`/usr/local/cuda/bin` (the toolkit's default prefix).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("attention", "loss")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # source name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> str:
    """The directory of this checkout's build, keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> str:
    """Compile every source not yet built, in parallel.  Returns the build
    directory."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    todo = [s for s in SOURCES
            if not os.path.exists(os.path.join(out_dir, f"lib{s}.so"))]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, os.path.join(out_dir, f"lib{name}.so"))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source (built first if need be)."""
    with _lock:
        if name not in _libs:
            path = os.path.join(build_all(), f"lib{name}.so")
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
