"""Device placement helpers for table storage, and the device mesh.

Port of ``multiverso_tpu/sharding/mesh.py``. The reference lays each
server shard out as a row-sharded ``jax.Array`` over the local device
mesh; the port's slice keeps a shard on ONE device (one card), so
``padded_size`` is a one-shard padding (the identity) and
``zeros_sharded`` is ``torch.zeros``.

The reference's collectives (``parallel/``) reduce over a 1-D mesh of
devices with axis ``"shard"``; its tests run them on 8 virtual devices
of one CPU. The port's ``Mesh`` is a tuple of replica SLOTS: n slots on
one device (n virtual devices of one card, or of the CPU), and a
collective over it is a reduction over the slot axis in slot order
(``kernels/mesh.py``). A mesh whose slots lie on different cards needs
NCCL and raises (ROADMAP B16-multi).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

SHARD_AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of replica slots: ``devices[s]`` holds slot s."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SHARD_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"a mesh over several devices {sorted(map(str, set(self.devices)))}"
                f" needs NCCL across cards, which multiverso_tpu_torch does "
                f"not port yet (ROADMAP B16-multi); slots of one device "
                f"reduce on it")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def device(self) -> torch.device:
        """The one device every slot lies on."""
        return self.devices[0]


def local_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D mesh of ``num_devices`` slots on ``device`` — ``cuda:0`` by
    default, which raises without a card; ``device="cpu"`` for the CPU.
    Without a count, one slot per visible CUDA device (one on the CPU):
    a mesh that then spans several cards raises (ROADMAP B16-multi)."""
    from ..runtime.zoo import resolve_device
    dev = resolve_device(device)
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices {num_devices} < 1")
        return Mesh((dev,) * int(num_devices))
    if dev.type == "cpu":
        return Mesh((dev,))
    return Mesh(tuple(torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())))


def device_count(mesh: Mesh) -> int:
    return len(mesh.devices)


def padded_size(n: int, num_shards: int = 1) -> int:
    """Smallest multiple of num_shards >= n (one shard: n itself)."""
    if num_shards <= 0:
        return n
    return ((n + num_shards - 1) // num_shards) * num_shards


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (table dtypes are numpy-typed at
    the API, as in the reference)."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def zeros_sharded(shape: Tuple[int, ...], dtype,
                  device: torch.device) -> torch.Tensor:
    """A zero table shard allocated directly on ``device``."""
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                       device=device)
