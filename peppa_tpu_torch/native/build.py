"""Build the native libraries at first use.

Two targets, each `g++ -O3 -std=c++17 -shared -fPIC -pthread` (the JAX
package's flags) of one source under `native/src/`:

- `loader`: `peppa_loader.cpp` -> `libpeppa_loader.so`, the batch loader;
- `ctc_align`: `ctc_align.cpp` -> `libpeppa_ctc_align.so`, the forced
  aligner's Viterbi DP.

Each goes to `peppa_tpu_torch/_build/native-<hash>/`, keyed by a hash of
its source and the flags; a later call in this or another process reuses
it.  A library is compiled under a temporary name and published with
`os.replace`, so concurrent builders do not see each other's partial files.
A failed build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "native", "src")
# target -> (source, library)
TARGETS = {"loader": ("peppa_loader.cpp", "libpeppa_loader.so"),
           "ctc_align": ("ctc_align.cpp", "libpeppa_ctc_align.so")}
SRC = os.path.join(SRC_DIR, TARGETS["loader"][0])
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# what the caller can do instead, per target, when the build fails
_INSTEAD = {"loader": " (set tpu.native_loader: false for the Python "
                      "loader)",
            "ctc_align": ""}

_lock = threading.Lock()


def library_path(target: str = "loader") -> str:
    """Where this checkout's build of a target lives."""
    source, name = TARGETS[target]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(SRC_DIR, source), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}", name)


def build(target: str = "loader") -> str:
    """Compile a target if it is not built yet; returns the library's
    path.  Raises RuntimeError when there is no g++ or it fails."""
    src = os.path.join(SRC_DIR, TARGETS[target][0])
    lib = library_path(target)
    with _lock:
        if os.path.exists(lib):
            return lib
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: the native {target} library "
                               f"cannot be built{_INSTEAD[target]}")
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
        os.close(fd)
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {src} (exit "
                                   f"{out.returncode}):\n{out.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib
