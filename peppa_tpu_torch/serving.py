"""Serving: the bucketed encoder service.

Mirrors peppa_tpu/serving.py.  Requests are grouped by duration bucket,
zero-padded to the bucket's shape and batched to `batch_size`; overlong
requests are cropped to the last bucket; video is canonicalised to uint8
first.  Every forward runs under `torch.inference_mode()` on the service's
device; results come back as numpy.

Usage:
    svc = EncoderService(init_model(config), config)
    svc.warmup()
    A = svc.embed_audio(list_of_waveforms)      # (N, 512) unit-norm
    V = svc.embed_video(list_of_clips)          # (N, 512)
    scores = svc.similarity(V, A)               # cosine matrix

    svc = EncoderService.from_checkpoint("lightning_logs/version_0")

`from_checkpoint` serves the best checkpoint of a run directory: the
port's, the JAX package's (flax msgpack) or the reference's (Lightning).

Over a mesh (`mesh=`, `parallel/mesh.py::make_mesh`; every rank of the
process group builds the service and is called with the same requests),
each padded batch's rows are split over the mesh's 'data' axis: each data
row of ranks encodes its batch_size / data rows with the whole model (the
parameters replicated, as the JAX service replicates them) and
`all_gather_rows` returns every row to every rank, so each rank's result
is the whole (N, 512) array.  batch_size must divide over the data axis.

Each call is a root span (`serve.embed_video`, `serve.embed_audio`,
`serve.similarity`) over `serve.pad` (canonicalising, grouping and padding
on the host), then per padded batch `serve.h2d`, `serve.encode` and
`serve.d2h` (`utils/profiling.py`).  The counters `serve.rows_real.<tower>`
(clips asked for) and `serve.rows_run.<tower>` (rows the tower ran,
padding and warm-up included) count the work.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.ops.similarity import cosine_matrix
from peppa_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.profiling import count, span
from peppa_tpu_torch.utils.request_batching import (canonicalize_video,
                                                    group_by_bucket,
                                                    padded_chunk)


class EncoderService:
    def __init__(self, model, config: Config, batch_size: int = 32,
                 buckets: Optional[Sequence[float]] = None,
                 fps: float = 10.0,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None):
        """`model` is moved to `device` (None: the card; raises without
        CUDA) and put in eval mode.  `mesh`: serve over its 'data' axis
        (module doc); None: one process."""
        if mesh is not None and mesh.data > 1 and batch_size % mesh.data:
            raise ValueError(
                f"batch_size {batch_size} must divide over the mesh's "
                f"data axis ({mesh.data})")
        self.mesh = mesh if mesh is not None and mesh.data > 1 else None
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.batch_size = batch_size
        self.buckets = tuple(buckets if buckets is not None
                             else config.tpu.bucket_durations)
        self.fps = fps
        self.sample_rate = config.data.audio_sample_rate
        w, h = config.data.target_size
        self._hw = (h, w)

    @classmethod
    def from_checkpoint(cls, version_dir: str,
                        device: Optional[Union[str, torch.device]] = None,
                        quantize_int8: Optional[bool] = None,
                        **kw) -> "EncoderService":
        """The service of a run directory's best checkpoint (by its
        monitor score; the port's, the JAX package's or the reference's,
        `training/checkpoint.py::load_best_model`), on `device` (None: the
        card; raises without CUDA).  `quantize_int8` overrides the
        checkpoint's `tpu.quantize_int8`: the model is built again with
        the flag and takes the same weights (W8A8 serving, `ops/quant.py`;
        the quantization happens at call time, so the checkpoint is the
        same).  `kw` goes to the constructor (`mesh=` serves over a
        mesh)."""
        from peppa_tpu_torch.models.dual_encoder import PeppaPig
        from peppa_tpu_torch.training.checkpoint import load_best_model

        model, config, _ = load_best_model(version_dir, device=device)
        if (quantize_int8 is not None
                and quantize_int8 != config.tpu.quantize_int8):
            config.tpu.quantize_int8 = quantize_int8
            rebuilt = PeppaPig(config)
            rebuilt.load_state_dict(model.state_dict())
            model = rebuilt
        return cls(model, config, device=device, **kw)

    # ------------------------------------------------------------- shapes
    def _audio_bucket(self, n_samples: int) -> int:
        for b in self.buckets:
            if n_samples <= int(round(b * self.sample_rate)):
                return int(round(b * self.sample_rate))
        return int(round(self.buckets[-1] * self.sample_rate))

    def _video_bucket(self, n_frames: int) -> int:
        for b in self.buckets:
            if n_frames <= int(round(b * self.fps)):
                return int(round(b * self.fps))
        return int(round(self.buckets[-1] * self.fps))

    # ------------------------------------------------------------ forward
    def _encode(self, encode: Callable[[torch.Tensor], torch.Tensor],
                batch: np.ndarray) -> np.ndarray:
        """`encode` of a padded batch; over a mesh, of this data row's
        rows, then every row gathered."""
        with torch.inference_mode():
            with span("serve.h2d"):
                x = torch.from_numpy(batch).to(self.device)
            with span("serve.encode"):
                if self.mesh is None:
                    y = encode(x)
                else:
                    y = all_gather_rows(
                        encode(shard_batch(x, self.mesh)).float(), self.mesh)
            with span("serve.d2h"):
                return y.float().cpu().numpy()

    def _audio_fn(self, batch: np.ndarray) -> np.ndarray:
        count("serve.rows_run.audio", len(batch))
        return self._encode(self.model.encode_audio, batch)

    def _video_fn(self, batch: np.ndarray) -> np.ndarray:
        count("serve.rows_run.video", len(batch))
        return self._encode(self.model.encode_video, batch)

    def warmup(self) -> None:
        """Run every (bucket, full batch) shape once: builds the kernels
        and lets cuDNN pick its algorithms before the first request."""
        h, w = self._hw
        for b in self.buckets:
            s = int(round(b * self.sample_rate))
            t = int(round(b * self.fps))
            self._audio_fn(np.zeros((self.batch_size, s), np.float32))
            self._video_fn(np.zeros((self.batch_size, t, h, w, 3), np.uint8))

    # -------------------------------------------------------------- embed
    def _run_bucketed(self, items: Sequence[np.ndarray],
                      bucket_of: Callable[[np.ndarray], int],
                      fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        out = np.zeros((len(items), 512), np.float32)
        with span("serve.pad"):
            groups = group_by_bucket(items, bucket_of)
        for size, idxs in groups.items():
            for lo in range(0, len(idxs), self.batch_size):
                chunk = idxs[lo:lo + self.batch_size]
                with span("serve.pad"):
                    batch = padded_chunk(items, chunk, size, self.batch_size,
                                         items[chunk[0]].shape[1:],
                                         items[chunk[0]].dtype)
                out[chunk] = fn(batch)[:len(chunk)]
        return out

    def embed_audio(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        """(S_i,) float32 waveforms -> (N, 512) unit-norm embeddings."""
        with span("serve.embed_audio"):
            with span("serve.pad"):
                waveforms = [np.asarray(x, np.float32).reshape(-1)
                             for x in waveforms]
            count("serve.rows_real.audio", len(waveforms))
            return self._run_bucketed(
                waveforms, lambda x: self._audio_bucket(x.shape[0]),
                self._audio_fn)

    def embed_video(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        """(T_i, H, W, 3) float [0, 1] or uint8 clips -> (N, 512)."""
        with span("serve.embed_video"):
            with span("serve.pad"):
                clips = [canonicalize_video(x) for x in clips]
            count("serve.rows_real.video", len(clips))
            return self._run_bucketed(
                clips, lambda x: self._video_bucket(x.shape[0]),
                self._video_fn)

    def similarity(self, video_emb: np.ndarray,
                   audio_emb: np.ndarray) -> np.ndarray:
        """Cosine matrix (len(video_emb), len(audio_emb)), float32."""
        with span("serve.similarity"), torch.inference_mode():
            v = torch.as_tensor(np.asarray(video_emb), device=self.device)
            a = torch.as_tensor(np.asarray(audio_emb), device=self.device)
            return cosine_matrix(v, a).cpu().numpy()
