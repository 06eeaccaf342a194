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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.ops.similarity import cosine_matrix
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.request_batching import (canonicalize_video,
                                                    group_by_bucket,
                                                    padded_chunk)


class EncoderService:
    def __init__(self, model, config: Config, batch_size: int = 32,
                 buckets: Optional[Sequence[float]] = None,
                 fps: float = 10.0,
                 device: Optional[Union[str, torch.device]] = None):
        """`model` is moved to `device` (None: the card; raises without
        CUDA) and put in eval mode."""
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
        card; raises without CUDA).  `quantize_int8=True` raises: W8A8 is
        not ported yet."""
        from peppa_tpu_torch.training.checkpoint import load_best_model

        if quantize_int8:
            raise NotImplementedError(
                "tpu.quantize_int8 (W8A8 towers) comes in a later slice")
        model, config, _ = load_best_model(version_dir, device=device)
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
    def _audio_fn(self, batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(self.device)
            return self.model.encode_audio(x).float().cpu().numpy()

    def _video_fn(self, batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(self.device)
            return self.model.encode_video(x).float().cpu().numpy()

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
        for size, idxs in group_by_bucket(items, bucket_of).items():
            for lo in range(0, len(idxs), self.batch_size):
                chunk = idxs[lo:lo + self.batch_size]
                batch = padded_chunk(items, chunk, size, self.batch_size,
                                     items[chunk[0]].shape[1:],
                                     items[chunk[0]].dtype)
                out[chunk] = fn(batch)[:len(chunk)]
        return out

    def embed_audio(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        """(S_i,) float32 waveforms -> (N, 512) unit-norm embeddings."""
        waveforms = [np.asarray(x, np.float32).reshape(-1) for x in waveforms]
        return self._run_bucketed(
            waveforms, lambda x: self._audio_bucket(x.shape[0]),
            self._audio_fn)

    def embed_video(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        """(T_i, H, W, 3) float [0, 1] or uint8 clips -> (N, 512)."""
        clips = [canonicalize_video(x) for x in clips]
        return self._run_bucketed(
            clips, lambda x: self._video_bucket(x.shape[0]), self._video_fn)

    def similarity(self, video_emb: np.ndarray,
                   audio_emb: np.ndarray) -> np.ndarray:
        """Cosine matrix (len(video_emb), len(audio_emb)), float32."""
        with torch.inference_mode():
            v = torch.as_tensor(np.asarray(video_emb), device=self.device)
            a = torch.as_tensor(np.asarray(audio_emb), device=self.device)
            return cosine_matrix(v, a).cpu().numpy()
