"""Process topology of a multi-process run over `torch.distributed`.

Mirrors peppa_tpu/utils/dist.py: exactly one process writes artifacts, and
every process contributes its local slab of each global batch.  The port
runs one process per card, launched by `torchrun`
(`torchrun --nproc_per_node=N -m peppa_tpu_torch.run ...`), which
`init_distributed` joins.

Kept as module-level functions, called through the module
(`dist.process_index()`), so that tests can monkeypatch `process_index` and
`process_count` to simulate a topology in one process.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as td

from peppa_tpu_torch.utils.device import resolve_device


def process_index() -> int:
    """This process's rank; 0 without an initialised process group."""
    if td.is_available() and td.is_initialized():
        return td.get_rank()
    return 0


def process_count() -> int:
    """The number of processes; 1 without an initialised process group."""
    if td.is_available() and td.is_initialized():
        return td.get_world_size()
    return 1


def is_main_process() -> bool:
    """True on exactly one process; gates checkpoint/metric/hparams writes."""
    return process_index() == 0


def init_distributed(device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group that `torchrun` describes (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and return
    this process's device.

    `device=None` binds the card `cuda:LOCAL_RANK` (`torch.cuda.set_device`)
    and raises without CUDA; "cpu" runs the rank on the host.  The backend
    is NCCL for a card and gloo for the host unless `backend` names one
    (gloo on the card carries the all-reduces of CUDA tensors, which lets
    two ranks share one card, where NCCL refuses them)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not td.is_initialized():
        td.init_process_group(backend, init_method="env://", rank=rank,
                              world_size=world)
    return dev
