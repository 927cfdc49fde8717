"""K20 key_sort: row ids sorted stably by the rows they name, on the card.

It replaces no program of the reference (JAX's ``.at[keys].add`` needs
no sort); the port's kernels that sum a row's occurrences in an order
fixed by the data need the flat positions grouped by row in position
order. K12 ``sparse_lr_apply`` (``logreg.py``), K13 ``row_rule_apply``
and K14's stateful arms on ids that can repeat (``rules.py``) run on
it.

Keys follow JAX's index rules: an id in [-R, -1] wraps to ``id + R``,
an id in [0, R) stays, every other id becomes R and sorts last. Returns
the sorted keys and each key's flat position, both int32.

On a CUDA tensor ``key_sort`` launches the kernel (``csrc/
key_sort.cu``: a stable radix sort over ``key_bits(R)`` bits in passes
of at most 10, ONE cooperative launch whose phases a grid-wide barrier
splits; no host sync) or raises; on a CPU tensor it runs the plain
version, ``torch.sort(stable=True)``. ``key_sort.launches`` counts its
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ._launch import is_plain, require, stream_of

#: Keys a tile of the kernel (``kTile``), and the widest digit.
TILE = 2048
MAX_DIGIT = 10
#: Kernels a ``key_sort`` call launches on the card.
KERNELS_A_CALL = 1


def key_bits(rows: int) -> int:
    """The bits the keys of a table of ``rows`` rows take: keys lie in
    [0, rows], the sentinel included."""
    return max(int(rows).bit_length(), 1)


def sort_keys(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The int64 keys of ``ids`` (flattened): wrapped, dropped ids R."""
    flat = ids.reshape(-1).to(torch.int64)
    flat = torch.where(flat < 0, flat + rows, flat)
    return torch.where((flat >= 0) & (flat < rows), flat,
                       torch.full_like(flat, rows))


def key_sort_plain(ids: torch.Tensor, rows: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K20: ``torch.sort(stable=True)`` of the keys."""
    keys, order = torch.sort(sort_keys(ids, rows), stable=True)
    return keys.to(torch.int32), order.to(torch.int32)


def key_sort(ids: torch.Tensor, rows: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K20: (keys, order), int32 ``[ids.numel()]``: the keys of the int32
    ``ids`` in a table of ``rows`` rows (``rows < 2^31``), sorted
    stably, and each one's flat position."""
    flat = ids.reshape(-1)
    if is_plain(flat):
        return key_sort_plain(flat, rows)
    require(flat, "ids", torch.int32, flat.device, 1)
    if not 0 <= rows < 2 ** 31:
        raise ValueError(f"key_sort: {rows} rows; the keys are int32")
    n = flat.numel()
    keys = torch.empty(n, dtype=torch.int32, device=flat.device)
    order = torch.empty(n, dtype=torch.int32, device=flat.device)
    if n == 0:
        return keys, order
    bits = key_bits(rows)
    tiles = -(-n // TILE)
    hist = -(-bits // MAX_DIGIT) * (tiles << MAX_DIGIT)
    scratch = torch.empty(2 * n + hist + (1 << MAX_DIGIT),
                          dtype=torch.int32, device=flat.device)
    lib = build.library()
    build.check(lib.mv_key_sort(
        flat.data_ptr(), n, rows, bits, keys.data_ptr(), order.data_ptr(),
        scratch[2 * n:].data_ptr(), scratch[2 * n + hist:].data_ptr(),
        scratch.data_ptr(), scratch[n:].data_ptr(), stream_of(flat)),
        "key_sort")
    key_sort.launches += 1
    return keys, order


key_sort.launches = 0
