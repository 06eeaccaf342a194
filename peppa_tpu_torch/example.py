"""Minimal public "embed audio" API: the counterpart of the root example.py.

Loads the best checkpoint of a run (the port's, the JAX package's or the
reference's run directory), embeds a glob of audio files (decoded at 44.1
kHz, as the root script's loader does), prints the embedding tensor's
shape.  Runs on the card (raises without CUDA) unless
`device` says otherwise.

    python -m peppa_tpu_torch.example --version_dir lightning_logs/version_0 \
        --audio_glob 'data/out/realign/narration/ep_1/0/*.wav'
"""

from __future__ import annotations

import argparse
import glob
from typing import Optional, Union

import numpy as np
import torch

from peppa_tpu_torch.data.audio import audiofile_loader
from peppa_tpu_torch.training.checkpoint import load_best_model


def main(version_dir: str, audio_glob: str,
         device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    model, _, _ = load_best_model(version_dir, device=device)
    dev = next(model.parameters()).device
    paths = sorted(glob.glob(audio_glob))
    with torch.inference_mode():
        emb = np.concatenate([
            model.encode_audio(torch.from_numpy(batch).to(dev))
            .float().cpu().numpy()
            for batch in audiofile_loader(paths)])
    print(f"Audio embedding tensor with shape: {emb.shape}")
    return emb


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--version_dir", default="lightning_logs/version_0")
    parser.add_argument("--audio_glob",
                        default="data/out/realign/narration/ep_1/0/*.wav")
    args = parser.parse_args()
    main(args.version_dir, args.audio_glob)
