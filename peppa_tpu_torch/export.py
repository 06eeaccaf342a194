"""Deployment artifacts: weight-free `torch.export` programs of the encoders.

Mirrors peppa_tpu/export.py, where `jax.export` writes one StableHLO program
per bucket shape.  Here the trained encoders are traced ONCE per (platform,
tower, bucket) static shape with `torch.export` and saved with the weights,
written once, and a manifest.  Loading an artifact needs torch, numpy and
this module's loader only: no model code, no checkpoint importers.

Each program is traced under `torch.no_grad()` with the tower's state as an
input (`torch.func.functional_call`), so that the graph lifts no weight,
and is saved without its example inputs: a program holds its graph and the
few plain tensor attributes that are not in the state (the video
normalisation's mean and std).  No decomposition is run: a program calls
the ATen ops that the eager model calls.  The attention forward is one
`peppa_tpu_torch.mha_attention` node per layer (`ops/cuda/attention.py`'s
custom op: the CUDA kernel on the card, the plain version on the CPU).  The
int8 products of a W8A8 tower choose their route by device while they are
traced (im2col + `torch._int_mm` on the card, a float64 conv on the CPU),
so a program belongs to the platform it was traced on, as `jax.export`'s
programs belong to their `platforms`; the loader takes the programs of its
device's platform and raises if the artifact has none.

Artifact layout (one directory):

    manifest.json               shapes/dtypes per program, buckets,
                                platforms, torch version, config snapshot
    variables.pt                the model's state_dict (`torch.save`)
    audio_s{S}.{platform}.pt2   encode_audio for (batch, S) float32
    video_t{T}.{platform}.pt2   encode_video for (batch, T, H, W, 3) uint8

Usage:
    # export (has a trained model)
    from peppa_tpu_torch.export import export_encoders
    export_encoders(model, config, "artifact/", batch_size=32)

    # serve (needs only torch + this loader + the artifact)
    from peppa_tpu_torch.export import ExportedEncoders
    enc = ExportedEncoders("artifact/")      # the card; device="cpu" too
    A = enc.embed_audio(list_of_waveforms)   # (N, 512) unit-norm
    V = enc.embed_video(list_of_clips)       # (N, 512)
    S = enc.similarity(V, A)

    python -m peppa_tpu_torch.export lightning_logs/version_0 artifact/
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

# registers the attention op, which the programs call
from peppa_tpu_torch.ops.cuda import attention  # noqa: F401
from peppa_tpu_torch.ops.similarity import cosine_matrix
from peppa_tpu_torch.utils.device import resolve_device
from peppa_tpu_torch.utils.request_batching import (canonicalize_video,
                                                    group_by_bucket,
                                                    padded_chunk)

FORMAT = "peppa-tpu-torch-export-v1"
PLATFORMS = ("cuda", "cpu")
_MANIFEST = "manifest.json"
_VARIABLES = "variables.pt"
_TOWERS = {"audio": "audio_encoder.", "video": "video_encoder."}


class _Encode(torch.nn.Module):
    """One tower's `encode_audio` / `encode_video` as a module."""

    def __init__(self, model, kind: str):
        super().__init__()
        self.model = model
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "audio":
            return self.model.encode_audio(x)
        return self.model.encode_video(x)


class _Program(torch.nn.Module):
    """(state, x) -> embeddings.  The encoder is kept out of this module's
    tree, so that `torch.export` lifts none of its weights: they come in
    as `state`."""

    def __init__(self, model, kind: str):
        super().__init__()
        object.__setattr__(self, "encode", _Encode(model, kind))

    def forward(self, state: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.encode, state, (x,))


def _tower_state(variables: Dict[str, torch.Tensor], kind: str
                 ) -> Dict[str, torch.Tensor]:
    """A program's `state` input: the tower's entries of the model's
    state_dict, in its order, under `_Encode`'s names."""
    prefix = _TOWERS[kind]
    return {"model." + k: v for k, v in variables.items()
            if k.startswith(prefix)}


# ----------------------------------------------------------------- export
def export_encoders(model, config, out_dir: str, batch_size: int = 32,
                    buckets: Optional[Sequence[float]] = None,
                    fps: float = 10.0,
                    platforms: Optional[Sequence[str]] = None) -> Dict:
    """Trace and save encode_audio / encode_video for every bucket shape
    on every platform ("cuda", "cpu"; None: the platform of the model's
    device).  The model is moved to each platform in turn and back.
    Returns the manifest dict."""
    buckets = tuple(buckets if buckets is not None
                    else config.tpu.bucket_durations)
    sample_rate = config.data.audio_sample_rate
    w, h = config.data.target_size
    home = next(model.parameters()).device
    plats = list(platforms) if platforms is not None else [home.type]
    for plat in plats:
        if plat not in PLATFORMS:
            raise ValueError(f"platform {plat!r} is not one of {PLATFORMS}")
    os.makedirs(out_dir, exist_ok=True)
    programs: List[Dict] = []
    try:
        for plat in plats:
            dev = resolve_device(plat)
            model.to(dev).eval()
            state = model.state_dict()
            for b in buckets:
                s = int(round(b * sample_rate))
                t = int(round(b * fps))
                for kind, shape, dtype, fname in (
                        ("audio", (batch_size, s), torch.float32,
                         f"audio_s{s}.{plat}.pt2"),
                        ("video", (batch_size, t, h, w, 3), torch.uint8,
                         f"video_t{t}.{plat}.pt2")):
                    logging.info("export: %s %s on %s -> %s", kind, shape,
                                 plat, fname)
                    t0 = time.perf_counter()
                    x = torch.zeros(shape, dtype=dtype, device=dev)
                    with torch.no_grad():
                        ep = torch.export.export(
                            _Program(model, kind),
                            (_tower_state(state, kind), x))
                    ep.example_inputs = None  # else the weights go in too
                    torch.export.save(ep, os.path.join(out_dir, fname))
                    programs.append({
                        "kind": kind, "file": fname, "bucket_s": b,
                        "input_shape": list(shape),
                        "input_dtype": str(dtype).replace("torch.", ""),
                        "platform": plat,
                        "export_s": time.perf_counter() - t0})
    finally:
        model.to(home)

    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, _VARIABLES))
    manifest = {
        "format": FORMAT,
        "batch_size": batch_size,
        "buckets": list(buckets),
        "sample_rate": sample_rate,
        "fps": fps,
        "frame_hw": [h, w],
        "platforms": plats,
        "torch_version": torch.__version__,
        "embed_dim": 512,
        "programs": programs,
        "config": config.to_dict(),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def op_counts(program_path: str) -> Dict[str, int]:
    """How often each operator is called in a saved program's graph, by
    name (e.g. "peppa_tpu_torch.mha_attention.default",
    "aten._int_mm.default")."""
    counts: Dict[str, int] = {}
    for node in torch.export.load(program_path).graph.nodes:
        if node.op == "call_function":
            name = str(node.target)
            counts[name] = counts.get(name, 0) + 1
    return counts


# ------------------------------------------------------------------- load
class ExportedEncoders:
    """Serve an `export_encoders` artifact without any model code, on
    `device` (None: the card; raises without CUDA).

    Mirrors EncoderService's bucketing contract (peppa_tpu_torch/
    serving.py, through the same `utils/request_batching.py`): items are
    grouped by duration bucket, zero-padded to the bucket's static shape,
    batched to the exported batch size; overlong items crop to the last
    bucket; video canonicalizes to uint8.  Programs run under
    `torch.inference_mode()`."""

    def __init__(self, path: str,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.path = path
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"not a peppa-tpu-torch export artifact: {path}")
        platform = self.device.type
        progs = [p for p in self.manifest["programs"]
                 if p["platform"] == platform]
        if not progs:
            raise ValueError(
                f"the artifact at {path} has no program for platform "
                f"{platform!r} (it has {self.manifest['platforms']})")
        self.batch_size = self.manifest["batch_size"]
        self.embed_dim = self.manifest["embed_dim"]
        variables = torch.load(os.path.join(path, _VARIABLES),
                               map_location=self.device, weights_only=True)
        self._states = {kind: _tower_state(variables, kind)
                        for kind in _TOWERS}
        self._programs: Dict[str, Dict[int, torch.nn.Module]] = {
            "audio": {}, "video": {}}
        for prog in progs:
            ep = torch.export.load(os.path.join(path, prog["file"]))
            size = prog["input_shape"][1]  # samples (audio) / frames (video)
            self._programs[prog["kind"]][size] = ep.module()

    # ------------------------------------------------------------ buckets
    def _bucket(self, kind: str, n: int) -> int:
        sizes = sorted(self._programs[kind])
        for s in sizes:
            if n <= s:
                return s
        return sizes[-1]

    def encode(self, kind: str, batch: torch.Tensor) -> torch.Tensor:
        """One program call on a (batch_size, size, ...) batch on the
        device, at one of the exported sizes -> (batch_size, 512)."""
        with torch.inference_mode():
            return self._programs[kind][batch.shape[1]](self._states[kind],
                                                        batch)

    def _run(self, kind: str, items: Sequence[np.ndarray]) -> np.ndarray:
        out = np.zeros((len(items), self.embed_dim), np.float32)
        groups = group_by_bucket(items,
                                 lambda x: self._bucket(kind, x.shape[0]))
        for size, idxs in groups.items():
            for lo in range(0, len(idxs), self.batch_size):
                chunk = idxs[lo:lo + self.batch_size]
                batch = padded_chunk(items, chunk, size, self.batch_size,
                                     items[chunk[0]].shape[1:],
                                     items[chunk[0]].dtype)
                emb = self.encode(kind, torch.from_numpy(batch)
                                  .to(self.device))
                out[chunk] = emb.float().cpu().numpy()[:len(chunk)]
        return out

    # -------------------------------------------------------------- embed
    def embed_audio(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        """(S_i,) float32 waveforms -> (N, 512) unit-norm embeddings."""
        waveforms = [np.asarray(x, np.float32).reshape(-1) for x in waveforms]
        return self._run("audio", waveforms)

    def embed_video(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        """(T_i, H, W, 3) float [0,1] or uint8 clips -> (N, 512) embeddings.

        Canonicalization is shared with the live EncoderService
        (utils/request_batching.py) so the exported path can't drift."""
        return self._run("video", [canonicalize_video(x) for x in clips])

    def similarity(self, video_emb: np.ndarray,
                   audio_emb: np.ndarray) -> np.ndarray:
        """Cosine matrix (len(video_emb), len(audio_emb)), float32, as
        EncoderService.similarity computes it."""
        with torch.inference_mode():
            v = torch.as_tensor(np.asarray(video_emb), device=self.device)
            a = torch.as_tensor(np.asarray(audio_emb), device=self.device)
            return cosine_matrix(v, a).cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: export the best checkpoint of a run dir as a serving artifact.

    python -m peppa_tpu_torch.export lightning_logs/version_0 artifact/ \
        [--batch_size 32] [--platforms cuda cpu]

    The model loads on the card unless `--platforms cpu` is the only
    platform."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("version_dir")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--platforms", nargs="+", default=None, choices=PLATFORMS,
                   help="e.g. --platforms cuda cpu for both (default: "
                        "cuda)")
    p.add_argument("--reference_ckpt", metavar="PATH", default=None,
                   help="instead of programs, write the best checkpoint as "
                        "a reference-compatible Lightning .ckpt (torch "
                        "tensors, pig/models.py naming)")
    args = p.parse_args(argv)
    if args.out_dir is None and not args.reference_ckpt:
        # pure argument validation: fail BEFORE the model load
        p.error("out_dir is required unless --reference_ckpt is given")

    logging.getLogger().setLevel(logging.INFO)
    from peppa_tpu_torch.training.checkpoint import load_best_model

    device = "cpu" if args.platforms == ["cpu"] else None
    model, config, ckpt_path = load_best_model(args.version_dir,
                                               device=device)
    if args.reference_ckpt:
        from peppa_tpu_torch.models.convert import (export_jax_variables,
                                                    save_reference_checkpoint)

        monitor = score = None
        epoch = 0
        sidecar = ckpt_path + ".json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                meta = json.load(f)
            monitor = meta.get("monitor")
            score = meta.get("best_model_score")
            epoch = meta.get("epoch", 0)
        save_reference_checkpoint(args.reference_ckpt,
                                  export_jax_variables(model), config,
                                  epoch=epoch, monitor=monitor, score=score)
        print(json.dumps({"reference_ckpt": args.reference_ckpt,
                          "from": ckpt_path, "monitor": monitor,
                          "score": score}))
        return
    logging.info("exporting %s -> %s", ckpt_path, args.out_dir)
    manifest = export_encoders(model, config, args.out_dir,
                               batch_size=args.batch_size,
                               platforms=args.platforms)
    print(json.dumps({"out_dir": args.out_dir,
                      "programs": len(manifest["programs"]),
                      "platforms": manifest["platforms"]}))


if __name__ == "__main__":
    main()
