"""Collectives over a mesh of replica slots.

Port of ``multiverso_tpu/parallel/collective.py``. The reference
declares a ``lax.psum`` inside a ``shard_map`` over its device mesh;
the port's mesh is n replica slots on one device (``sharding/mesh.py``),
and the collective is K19 ``mesh_allreduce`` (``kernels/mesh.py``): the
sum over the slot axis in slot order — the order of the reference's
psum on its 8-device CPU mesh — launched on a CUDA tensor, its plain
version on a CPU tensor. ``net::Allreduce`` (ref: include/multiverso/
net.h:51-57) maps to ``allreduce_mesh``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.mesh import mesh_allreduce
from ..sharding import mesh as meshlib


def _on_mesh(x, mesh) -> torch.Tensor:
    """``x`` as a contiguous tensor on the mesh's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(mesh.device).contiguous()


def _slots(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` [n*k, ...] as [n, k*...]: row s is slot s's shard."""
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"leading dimension of {tuple(x.shape)} does not "
                         f"split over {n} slots")
    return x.reshape(n, -1)


def allreduce_mesh(x, mesh=None) -> torch.Tensor:
    """Sum contributions laid shard-wise along the leading dim: the
    array's leading dim is split over the mesh's slots, every shard is
    summed, and each shard of the result holds the total. For the
    common 'every slot has a full gradient' case, stack the per-slot
    arrays on axis 0."""
    mesh = mesh if mesh is not None else meshlib.local_mesh()
    x = _on_mesh(x, mesh)
    n = meshlib.device_count(mesh)
    return mesh_allreduce(_slots(x, n), copies=n).reshape(x.shape)


def psum_scalar(value: float, mesh=None) -> float:
    """Each slot contributes ``value``; returns value * n_slots (the
    slot-ordered float32 sum). The tiniest collective — used as a
    device-level barrier probe."""
    mesh = mesh if mesh is not None else meshlib.local_mesh()
    n = meshlib.device_count(mesh)
    contrib = torch.full((n, 1), value, dtype=torch.float32,
                         device=mesh.device)
    return float(mesh_allreduce(contrib, copies=n)[0, 0])


def pmean_mesh(x, mesh=None) -> torch.Tensor:
    """Mean-allreduce (model averaging over the mesh): the allreduce
    divided by n, each shard of the result the mean."""
    mesh = mesh if mesh is not None else meshlib.local_mesh()
    x = _on_mesh(x, mesh)
    n = meshlib.device_count(mesh)
    return mesh_allreduce(_slots(x, n), mean=True,
                          copies=n).reshape(x.shape)
