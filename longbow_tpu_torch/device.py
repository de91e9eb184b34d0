"""Where the port's entry points run.

Every entry point takes a `device`. Left as None it means the CUDA card;
without one the call raises instead of quietly running on the CPU. Tests
and CPU users pass device="cpu" explicitly.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> the current CUDA device (RuntimeError when there is none);
    anything else is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def entry_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of a process entry point (the server, the tools): `device`
    when given, the CPU under LONGBOW_FORCE_CPU=1 (the reference's flag),
    else the CUDA card (RuntimeError without one)."""
    if device is None and os.environ.get("LONGBOW_FORCE_CPU") == "1":
        return torch.device("cpu")
    return resolve_device(device)
