"""The system under test as the benchmark builds it: `peppa_tpu_torch`'s
dual encoder, holding the weights the benchmark drew.

The model is built on the device and takes the drawn tensors by name
(`load_state_dict(strict=True)`: the reference's `param_spec` and the
program's parameters must name and shape alike), so the program's own
CPU-side initialisation never runs.
"""

from __future__ import annotations

import torch
from torch import nn

from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.dual_encoder import PeppaPig


def port_config(hp: dict) -> Config:
    return Config.from_dict(hp)


def build_model(hp: dict, weights, device) -> PeppaPig:
    """The program's model of configuration `hp` on `device`, holding
    `weights`, in eval mode."""
    with torch.device(device):
        model = PeppaPig(port_config(hp))
    model.load_state_dict(weights, strict=True)
    return model.eval()


class RowCounter(nn.Module):
    """The model a service is handed, counting the rows each tower call
    receives."""

    def __init__(self, model: PeppaPig):
        super().__init__()
        self.model = model
        self.rows = {"audio": 0, "video": 0}

    def encode_audio(self, audio, *args, **kw):
        self.rows["audio"] += int(audio.shape[0])
        return self.model.encode_audio(audio, *args, **kw)

    def encode_video(self, video, *args, **kw):
        self.rows["video"] += int(video.shape[0])
        return self.model.encode_video(video, *args, **kw)
