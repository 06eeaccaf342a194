"""Write random training audio clips as WAV files, to listen to.

    python -m peppa_tpu_torch.generate_sample_to_check

The port's counterpart of the root generate_sample_to_check.py (reference
generate_sample_to_check.py): `k` items of the dialog training set (the
item cache of the config's `data.train` windows, under `data/`), drawn
with the global `random` module, each written as `{i}.wav` (mono, 16-bit,
at `data.audio_sample_rate`) under `data/out/audio_sample_to_check`, from
`hparams_base.yaml` (`sample`'s arguments).  Runs no model; PyYAML reads
the config.
"""

from __future__ import annotations

import os
import random
import wave

import numpy as np


def sample(k: int = 50, config_file: str = "hparams_base.yaml",
           out_dir: str = "data/out/audio_sample_to_check") -> None:
    import yaml

    from peppa_tpu_torch.data.dataset import PeppaPigDataset

    with open(config_file) as f:
        hparams = yaml.safe_load(f)
    data_cfg = hparams["data"]
    train = PeppaPigDataset(
        target_size=tuple(data_cfg["target_size"]),
        audio_sample_rate=data_cfg["audio_sample_rate"],
        split=["train"], fragment_type="dialog",
        **{k_: v for k_, v in data_cfg["train"].items()
           if k_ not in ("batch_size", "shuffle", "force_cache")})
    os.makedirs(out_dir, exist_ok=True)
    sr = data_cfg["audio_sample_rate"]
    for i in random.sample(range(len(train)), k):
        audio = np.asarray(train[i].audio).reshape(-1)
        with wave.open(os.path.join(out_dir, f"{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(audio, -1, 1) * 32767)
                          .astype("<i2").tobytes())


if __name__ == "__main__":
    sample()
