"""K19 mesh_allreduce: the reduction over a mesh's slot axis.

Replaces the reference's device-mesh collectives (B16): the ``psum`` of
``allreduce_mesh`` and ``psum_scalar`` and the ``pmean`` of
``pmean_mesh`` (``multiverso_tpu/parallel/collective.py:30-73``), of
``MASGDStep`` (``parallel/ma.py:305-339``) and of ``_ma_group_fn``
(``models/wordembedding/device_train.py:439-506``). The port's mesh is
n replica slots on one device (``sharding/mesh.py``), so the collective
is a reduction of ``x[n, M]`` (row r is slot r) over its rows, in slot
order — on the reference's 8-device CPU mesh ``psum`` is exactly that
sequential sum — then one division by n for the mean, written to
``copies`` rows: 1 for a replicated result, n for every slot's shard
of an allreduce.

On a CUDA tensor the wrapper launches the kernel (``csrc/
mesh_reduce.cu``: a thread owns float4 element columns, n = 2, 4 and 8
instantiated with every slot's loads of a thread's columns in flight
before its first add, streaming loads and stores, a block a tile of
columns; correctly rounded adds and division — bound by bytes,
``(n + copies) * M * 4``) or raises; on a CPU tensor it runs the plain
version, which takes the same operations in the same order, so the two
agree bit for bit. ``mesh_allreduce.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .flush import flush as f

MAX_SLOTS = 64  # csrc/mesh_reduce.cu kMaxSlots


def mesh_allreduce_plain(x: torch.Tensor, mean: bool = False,
                         copies: int = 1) -> torch.Tensor:
    """Plain version of K19: ``[copies, M]``, every row the slot-ordered
    sum of ``x``'s rows (divided by n for the mean), each add and the
    division flushed (ROADMAP C12; one slot is copied, not added)."""
    n = x.shape[0]
    acc = x[0].clone()
    for r in range(1, n):
        acc = f(f(acc) + f(x[r]))
    if mean:
        # A 0-d tensor divisor: a true division (a Python scalar would
        # let CUDA multiply by its reciprocal).
        acc = f(f(acc) / torch.full((), n, dtype=acc.dtype,
                                    device=acc.device))
    return acc.unsqueeze(0).repeat(copies, *([1] * acc.dim()))


def mesh_allreduce(x: torch.Tensor, mean: bool = False,
                   copies: int = 1) -> torch.Tensor:
    """K19 on float32 ``x`` [n, M] with 1 <= n <= 64 slots: returns
    float32 [copies, M] (1 <= copies <= n), each row the sum over the
    slots in slot order, or with ``mean`` that sum divided by n."""
    n = int(x.shape[0]) if x.dim() else 0
    if not 1 <= copies <= max(n, 1):
        raise ValueError(f"copies {copies} outside [1, {n}]")
    if is_plain(x):
        return mesh_allreduce_plain(x, mean, copies)
    require(x, "x", torch.float32, x.device, 2)
    if not 1 <= n <= MAX_SLOTS:
        raise ValueError(f"{n} slots: the kernel takes 1 to {MAX_SLOTS}")
    m = int(x.shape[1])
    out = torch.empty(copies, m, dtype=torch.float32, device=x.device)
    build.check(build.library().mv_mesh_allreduce(
        x.data_ptr(), n, m, int(bool(mean)), copies, out.data_ptr(),
        stream_of(x)), "mesh_allreduce")
    mesh_allreduce.launches += 1
    return out


mesh_allreduce.launches = 0
