"""Build the native loader library at first use.

`g++ -O3 -std=c++17 -shared -fPIC -pthread` (the JAX package's flags) of
`native/src/peppa_loader.cpp` into
`peppa_tpu_torch/_build/native-<hash>/libpeppa_loader.so`, keyed by a hash
of the source and the flags; a later call in this or another process reuses
it.  The library is compiled under a temporary name and published with
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
SRC = os.path.join(_PKG, "native", "src", "peppa_loader.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()


def library_path() -> str:
    """Where this checkout's build of the loader lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libpeppa_loader.so")


def build() -> str:
    """Compile the loader if it is not built yet; returns the library's
    path.  Raises RuntimeError when there is no g++ or it fails."""
    lib = library_path()
    with _lock:
        if os.path.exists(lib):
            return lib
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native loader cannot be "
                               "built (set tpu.native_loader: false for the "
                               "Python loader)")
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
        os.close(fd)
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {SRC} (exit "
                                   f"{out.returncode}):\n{out.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib
