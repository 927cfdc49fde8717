"""Device placement helpers for table storage.

Port of ``multiverso_tpu/sharding/mesh.py``. The reference lays each
server shard out as a row-sharded ``jax.Array`` over the local device
mesh; the port's slice keeps a shard on ONE device (one card), so the
mesh collapses to that device, ``padded_size`` to a one-shard padding
(the identity) and ``zeros_sharded`` to ``torch.zeros``. Sharding a
table over several local cards is a later item of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
