"""The device mesh: one entry per shard.

Counterpart of longbow_tpu/parallel/mesh.py. longbow_tpu's mesh is a
jax.sharding.Mesh over jax.devices(), driven by one process through
shard_map; here it is the tuple of torch devices that one process
drives, shard j on devices[j]. A device may stand in the tuple more than
once (logical shards on one card, as the tests' 8 virtual CPU devices
are on one CPU) when the Mesh is built explicitly; make_mesh never
repeats one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

SHARD_AXIS = "shards"


@dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D mesh along SHARD_AXIS, one per shard."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, *, device=None) -> Mesh:
    """1-D mesh over the first n CUDA devices (None: all of them);
    ValueError when there are fewer, RuntimeError when there is no card.
    device="cpu" makes n CPU shards instead (None: one), the counterpart
    of longbow_tpu's tests on virtual CPU devices."""
    if device is not None and torch.device(device).type == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' for a mesh of "
            "CPU shards"
        )
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"asked for {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
