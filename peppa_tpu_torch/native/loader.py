"""ctypes bindings of the native loader (`native/src/peppa_loader.cpp`).

Mirrors peppa_tpu/native/loader.py.  `NativePack` mmaps a pack
(`data/cache.py`); `NativeBatchLoader` drives the C++ worker pool, which
assembles padded batches in background threads, and yields each as a
`ClipBatch` of CPU tensors: uint8 video, audio in the pack's dtype (float32
or int16), the durations and the valid extents.  When CUDA is available
the C++ side copies each batch straight into pinned tensors from PyTorch's
caching host allocator, so the copy to the card reads them with no
staging copy; the blocks are reused once a batch is freed.  `bucket_plan`
makes the loader's plan as `data/dataset.py::bucketed_batches` batches, so
both loaders give the same batches for a seed.

The library is built at first use (`native/build.py`); a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, Sequence

import numpy as np
import torch

from peppa_tpu_torch.data.types import ClipBatch
from peppa_tpu_torch.utils.profiling import count


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from peppa_tpu_torch.native.build import build

    lib = ctypes.CDLL(build())
    lib.ppk_open.restype = ctypes.c_void_p
    lib.ppk_open.argtypes = [ctypes.c_char_p]
    lib.ppk_close.restype = None
    lib.ppk_close.argtypes = [ctypes.c_void_p]
    lib.ppk_len.restype = ctypes.c_uint64
    lib.ppk_len.argtypes = [ctypes.c_void_p]
    lib.ppk_version.restype = ctypes.c_uint32
    lib.ppk_version.argtypes = [ctypes.c_void_p]
    lib.ppk_item_meta.restype = ctypes.c_int
    lib.ppk_item_meta.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_float)]
    lib.ppk_item_data.restype = ctypes.c_int
    lib.ppk_item_data.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.ppk_loader_new.restype = ctypes.c_void_p
    lib.ppk_loader_new.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_uint32,
                                   ctypes.c_uint32]
    lib.ppk_loader_next.restype = ctypes.c_int64
    lib.ppk_loader_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.ppk_loader_free.restype = None
    lib.ppk_loader_free.argtypes = [ctypes.c_void_p]
    return lib


class NativePack:
    """A pack, mmapped and bounds-checked by the C++ runtime."""

    def __init__(self, path: str):
        lib = _lib()
        self._lib = lib
        self._handle = lib.ppk_open(path.encode())
        if not self._handle:
            raise IOError(f"cannot open pack {path}")
        self.path = path
        self.version = int(lib.ppk_version(self._handle))
        self.audio_dtype = np.int16 if self.version == 2 else np.float32

    def __len__(self) -> int:
        return int(self._lib.ppk_len(self._handle))

    def meta(self, i: int):
        """((t, h, w, c), samples, video duration, audio duration)."""
        m = (ctypes.c_uint64 * 5)()
        d = (ctypes.c_float * 2)()
        if self._lib.ppk_item_meta(self._handle, i, m, d) != 0:
            raise IndexError(i)
        return ((int(m[0]), int(m[1]), int(m[2]), int(m[3])), int(m[4]),
                float(d[0]), float(d[1]))

    def item(self, i: int):
        """(video, audio, video duration, audio duration) of item i as
        numpy arrays."""
        (t, h, w, c), s, vd, ad = self.meta(i)
        video = np.empty((t, h, w, c), np.uint8)
        audio = np.empty((s,), self.audio_dtype)
        if self._lib.ppk_item_data(self._handle, i, video.ctypes.data,
                                   audio.ctypes.data) != 0:
            raise IndexError(i)
        return video, audio, vd, ad

    def durations(self) -> np.ndarray:
        """(n_items, 2) float32: video and audio duration of each item."""
        return np.asarray([self.meta(i)[2:] for i in range(len(self))],
                          np.float32)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ppk_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeBatchLoader:
    """Iterator over the padded batches of `plan`, assembled by the C++
    worker pool (`n_threads` threads, up to `depth` batches ahead).

    `plan` holds one (item indices, (pad_t, pad_h, pad_w, pad_c, pad_s))
    entry per batch.  The counter `NativeBatchLoader.served`
    (`utils/profiling.py`) counts the batches every loader of the process
    has handed out."""

    def __init__(self, pack: NativePack, plan: Sequence,
                 n_threads: int = 4, depth: int = 4):
        self._pack = pack
        self._lib = pack._lib
        self._plan = list(plan)
        self._pin = torch.cuda.is_available()
        items = (np.concatenate([np.asarray(p[0], np.int64)
                                 for p in self._plan])
                 if self._plan else np.zeros((0,), np.int64))
        sizes = np.asarray([len(p[0]) for p in self._plan], np.int64)
        pads = np.asarray([list(p[1]) for p in self._plan],
                          np.int64).reshape(-1)
        # the C++ side copies these when it is made; kept for its lifetime
        self._args = (items, sizes, pads)
        self._handle = self._lib.ppk_loader_new(
            pack._handle, items.ctypes.data, sizes.ctypes.data,
            pads.ctypes.data, len(self._plan), n_threads, depth)

    def __len__(self) -> int:
        return len(self._plan)

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    def __iter__(self) -> Iterator[ClipBatch]:
        audio_dtype = (torch.int16 if self._pack.audio_dtype == np.int16
                       else torch.float32)
        for idx_list, (pt, ph, pw, pc, ps) in self._plan:
            b = len(idx_list)
            video = self._empty((b, pt, ph, pw, pc), torch.uint8)
            audio = self._empty((b, ps), audio_dtype)
            vdur = self._empty((b,), torch.float32)
            adur = self._empty((b,), torch.float32)
            vframes = self._empty((b,), torch.int32)
            asamples = torch.empty((b,), dtype=torch.int64)
            got = self._lib.ppk_loader_next(
                self._handle, video.data_ptr(), audio.data_ptr(),
                vdur.data_ptr(), adur.data_ptr(), vframes.data_ptr(),
                asamples.data_ptr())
            if got < 0:
                return
            samples = self._empty((b,), torch.int32)
            samples.copy_(asamples)
            count("NativeBatchLoader.served")
            yield ClipBatch(video=video, audio=audio,
                            video_duration=vdur, audio_duration=adur,
                            video_frames=vframes, audio_samples=samples)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ppk_loader_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def bucket_plan(durations: np.ndarray, buckets: Sequence[float],
                batch_size: int, target_hw: tuple, sample_rate: int,
                fps: float = 10.0, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True):
    """A `NativeBatchLoader` plan: items shuffled by
    `np.random.default_rng(seed)`, grouped by the smallest bucket that holds
    max(video, audio duration), each batch padded to its bucket's shape."""
    w, h = target_hw
    order = np.arange(len(durations))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    def pad(b):
        return (int(round(b * fps)), h, w, 3, int(round(b * sample_rate)))

    pending = {b: [] for b in buckets}
    plan = []
    for j in order:
        d = max(durations[j][0], durations[j][1])
        b = next((bk for bk in buckets if d <= bk), buckets[-1])
        pending[b].append(int(j))
        if len(pending[b]) == batch_size:
            plan.append((pending[b], pad(b)))
            pending[b] = []
    if not drop_last:
        for b, items in pending.items():
            if items:
                plan.append((items, pad(b)))
    return plan
