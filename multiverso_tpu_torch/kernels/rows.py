"""K2 row_gather and K3 row_scatter_add: the table's row data plane;
K15 row_gather_bounded and K16 row_scatter_add_bounded: the same over a
server shard's window of global ids (tables of several servers).

``row_gather`` replaces ``MatrixServer._gather``
(``multiverso_tpu/tables/matrix_table.py:2760-2764``) and
``row_scatter_add`` replaces ``DefaultRule.rows`` / ``SGDRule.rows``
(``multiverso_tpu/updater/rules.py:94-105``) as driven by
``UpdateEngine.apply_rows`` (``multiverso_tpu/updater/engine.py:
73-128``). Both follow JAX's index semantics: ids in [-R, -1] wrap to
the end of the table, every other out-of-range id (the pad sentinel R
among them) gathers a zero row or is dropped.

``row_gather_bounded`` replaces ``MatrixServer._gather_bounded``
(``multiverso_tpu/tables/matrix_table.py:2777-2796``) and
``row_scatter_add_bounded`` replaces ``UpdateEngine._bounded_rows_fn``
(``multiverso_tpu/updater/engine.py:132-153``): a device-key request
reaches every server of a table with the same GLOBAL ids; server s
reads or adds row ``id - ofs`` for the ids of its window ``[ofs, ofs +
n)`` and zeros or drops every other id — negative ids too, which do not
wrap here (ROADMAP C8). The ids and deltas are shared by every server
(the request travels by reference), so neither kernel writes them.

On a CUDA tensor each wrapper launches its kernel
(``csrc/row_gather.cu``, ``csrc/row_scatter_add.cu``; all bound by
bytes) or raises; on a CPU tensor it runs the plain version beside it.
Each wrapper's ``launches`` counts its wrapper calls that reached the
card.

The scatters are deterministic on the card: no atomics, every table
row has one writer. ``row_scatter_add(..., distinct=True)`` is for ids
whose in-range members neither repeat nor go down (host ids the engine
found ascending, ``torch.unique`` output): one thread an element, no
sort; the plain version CHECKs the claim. Otherwise (and always for
K16) the ids are mapped to keys and sorted stably on the card
(``scatter_plan``, torch), and the kernel sums each run of equal keys
in position order, cutting runs longer than ``CHUNK`` into a tree of
sequential sums (``scatter_levels``). ``row_scatter_add_ordered`` is the
plain version of that order: bit for bit the kernel's sums on any
device, and bit for bit the sequential plain version wherever no run
crosses a cut.

Every float operation flushes float32 subnormals on its inputs and its
result, as the reference's (``flush``): the kernels through ``-ftz=true``,
the plain versions through ``flush.add_rows`` and ``flush.flush``. A
gather moves bits and flushes nothing.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import build
from ._launch import is_plain, require, stream_of
from .flush import add_rows, flush


def _wrapped(ids: torch.Tensor, rows: int):
    """(int64 ids with [-R, -1] wrapped, in-range mask)."""
    flat = ids.reshape(-1).to(torch.int64)
    flat = torch.where(flat < 0, flat + rows, flat)
    ok = (flat >= 0) & (flat < rows)
    return flat, ok


def row_gather_plain(data: torch.Tensor, ids: torch.Tensor,
                     n_col: int) -> torch.Tensor:
    """Plain version of K2: ``out[i] = data[ids[i], :n_col]``, zero rows
    for out-of-range ids. The ids are masked BEFORE ``index_select``,
    which raises on an out-of-range index."""
    flat, ok = _wrapped(ids, data.shape[0])
    rows = data.index_select(0, torch.where(ok, flat, 0))[:, :n_col]
    out = torch.where(ok[:, None], rows, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))
    return out.reshape(*ids.shape, n_col)


def row_gather(data: torch.Tensor, ids: torch.Tensor,
               n_col: int) -> torch.Tensor:
    """K2: gather ``data[ids, :n_col]`` into a new ``ids.shape +
    (n_col,)`` tensor. ``data`` is float32 [R, S] with S >= n_col,
    ``ids`` int32 on the same device."""
    if is_plain(data):
        return row_gather_plain(data, ids, n_col)
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    if not 0 < n_col <= data.shape[1]:
        raise ValueError(f"n_col {n_col} outside (0, {data.shape[1]}]")
    k = ids.numel()
    out = torch.empty((k, n_col), dtype=torch.float32, device=data.device)
    lib = build.library()
    build.check(lib.mv_row_gather(
        data.data_ptr(), data.shape[0], data.stride(0), ids.data_ptr(), k,
        out.data_ptr(), n_col, stream_of(data)), "row_gather")
    row_gather.launches += 1
    return out.reshape(*ids.shape, n_col)


row_gather.launches = 0


#: Sorted positions one task of the sorted scatter walks (``kChunk`` of
#: ``csrc/row_scatter_add.cu``).
CHUNK = 32


def _check_distinct(ids: torch.Tensor, k: int, rows: int) -> None:
    """Raise unless the in-range ids among the first ``k`` (wrapped as
    JAX wraps them) strictly ascend: the claim ``distinct=True`` makes."""
    flat, ok = _wrapped(ids.reshape(-1)[:k], rows)
    kept = flat[ok]
    if kept.numel() > 1 and not bool((kept[1:] > kept[:-1]).all()):
        raise ValueError("distinct=True, but the in-range ids repeat or "
                         "go down")


def row_scatter_add_plain(data: torch.Tensor, ids: torch.Tensor,
                          delta: torch.Tensor, sign: float = 1.0,
                          distinct: bool = False) -> None:
    """Plain version of K3: ``data[ids[i], :d] += sign * delta[i]`` for
    the first ``delta.shape[0]`` ids, in place, duplicates summed in
    position order, each add flushed (``flush.add_rows``); out-of-range
    ids are masked out first. ``distinct``: CHECK the caller's claim
    first (``_check_distinct``)."""
    k_delta, d_cols = delta.shape
    if distinct:
        _check_distinct(ids, k_delta, data.shape[0])
    flat, ok = _wrapped(ids.reshape(-1)[:k_delta], data.shape[0])
    src = delta[ok]
    if sign < 0:
        src = -src
    add_rows(data[:, :d_cols], flat[ok], src)


class ScatterPlan(NamedTuple):
    """The sorted scatter's id preparation: ``keys`` (int32, a key in
    ``[0, rows)`` names a row of the table, any other is skipped) sorted
    stably, so each row's occurrences form a run in position order, and
    ``order`` (int64), each sorted key's delta row."""
    keys: torch.Tensor
    order: torch.Tensor
    rows: int


def scatter_plan(ids: torch.Tensor, k: int, rows: int,
                 window: Optional[Tuple[int, int]] = None) -> ScatterPlan:
    """Keys of the first ``k`` ids, sorted on the ids' device (no host
    sync): ids in [-rows, -1] wrapped as JAX wraps them (K3), or with
    ``window=(ofs, n)`` the local row ``id - ofs`` of the ids in ``[ofs,
    ofs + n)`` and -1 for the others (K16, no wrap)."""
    flat = ids.reshape(-1)[:k]
    if window is None:
        keys = torch.where(flat < 0, flat + rows, flat)
    else:
        ofs, n = window
        keys = torch.where((flat >= ofs) & (flat < ofs + n), flat - ofs,
                           torch.full_like(flat, -1))
        rows = n
    keys, order = torch.sort(keys, stable=True)
    return ScatterPlan(keys, order, rows)


def run_heads(keys: torch.Tensor) -> torch.Tensor:
    """Where a run of equal sorted keys starts (bool, one a key)."""
    heads = torch.ones_like(keys, dtype=torch.bool)
    heads[1:] = keys[1:] != keys[:-1]
    return heads


def scatter_levels(n: int, chunk: int = CHUNK) -> List[int]:
    """Key counts of the sorted scatter's levels: ``n`` sorted keys cut
    into tasks of ``chunk``, then two slots a task, until one task holds
    a level (the kernel's launches, one a level)."""
    sizes = [n]
    while n > chunk:
        n = 2 * (-(-n // chunk))
        sizes.append(n)
    return sizes


def _ordered_level(data: torch.Tensor, keys: torch.Tensor,
                   vals: torch.Tensor, rows: int):
    """One level of the sorted scatter in the kernel's order, in place
    on ``data``: each run inside a task is added to its table row in
    position order; each run crossing a cut leaves a partial sum a task
    in its slots. Returns the next level's (slot keys, slot rows), or
    None after the last level."""
    n, d = vals.shape
    dev = keys.device
    tasks = -(-n // CHUNK)
    pad = tasks * CHUNK - n
    K = torch.cat([keys, keys.new_full((pad,), -1)]).view(tasks, CHUNK)
    V = torch.cat([vals, vals.new_zeros((pad, d))]).view(tasks, CHUNK, d)
    task = torch.arange(tasks, device=dev)
    lo = task * CHUNK
    cnt = torch.clamp(n - lo, max=CHUNK)
    first, last = K[:, 0], K[task, cnt - 1]
    before = (lo > 0) & (keys[(lo - 1).clamp(min=0)] == first)
    after = (lo + cnt < n) & (keys[(lo + cnt).clamp(max=n - 1)] == last)
    table = data[:, :d]
    slots = vals.new_zeros((tasks, 2, d))
    acc = vals.new_zeros((tasks, d))
    head = torch.zeros(tasks, dtype=torch.bool, device=dev)
    for t in range(CHUNK):
        live = t < cnt
        key = K[:, t]
        start = live if t == 0 else live & (K[:, t - 1] != key)
        head = torch.where(start, before if t == 0 else
                           torch.zeros_like(before), head)
        tail = after & (key == last)
        x0 = table.index_select(0, key.clamp(0, max(rows - 1, 0)).long())
        init = torch.where((head | tail)[:, None], torch.zeros_like(x0), x0)
        acc = flush(torch.where(start[:, None], flush(init), acc) + V[:, t])
        end = live & ((t + 1 >= cnt) |
                      (K[:, min(t + 1, CHUNK - 1)] != key))
        fin = end & (key >= 0) & (key < rows)
        slots[:, 0] = torch.where((fin & head)[:, None], acc, slots[:, 0])
        slots[:, 1] = torch.where((fin & ~head & tail)[:, None], acc,
                                  slots[:, 1])
        own = fin & ~head & ~tail
        table.index_put_((key[own].long(),), acc[own])
    if tasks == 1:
        return None
    minus = torch.full_like(first, -1)
    slot_keys = torch.stack([torch.where(before, first, minus),
                             torch.where(after, last, minus)], 1)
    return slot_keys.reshape(-1), slots.reshape(2 * tasks, d)


def row_scatter_add_ordered(data: torch.Tensor, plan: ScatterPlan,
                            delta: torch.Tensor, sign: float = 1.0) -> None:
    """The sorted scatter's sums in the kernel's order, in place, on any
    device: ``data[key] += sign * delta[order]`` over ``plan``. The
    kernel (``mv_row_scatter_add_sorted``) must match it bit for bit,
    subnormals flushed as the kernel's ``.ftz`` adds flush them."""
    if plan.keys.numel() == 0:
        return
    vals = flush(delta.index_select(0, plan.order) * sign)
    level = (plan.keys, vals)
    while level is not None:
        level = _ordered_level(data, level[0], level[1], plan.rows)


def level_slots(n: int, d: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Scratch of the sorted scatter's levels over ``n`` keys and rows of
    ``d`` floats: (slot keys, slot rows, cap_a). The levels ping-pong
    between two areas, the first ``cap_a`` slots for levels 1, 3, ...,
    the rest for 2, 4, ... (``mv_row_scatter_add_sorted``)."""
    sizes = scatter_levels(n)
    cap_a = sizes[1] if len(sizes) > 1 else 0
    cap_b = sizes[2] if len(sizes) > 2 else 0
    slot_keys = torch.empty(cap_a + cap_b, dtype=torch.int32, device=device)
    slot_vals = torch.empty((cap_a + cap_b) * d, dtype=torch.float32,
                            device=device)
    return slot_keys, slot_vals, cap_a


def _scatter_sorted(data: torch.Tensor, plan: ScatterPlan,
                    delta: torch.Tensor, sign: float, what: str) -> None:
    """Launch the sorted scatter over ``plan`` (levels in one call)."""
    n, d = plan.keys.numel(), delta.shape[1]
    slot_keys, slot_vals, cap_a = level_slots(n, d, data.device)
    lib = build.library()
    build.check(lib.mv_row_scatter_add_sorted(
        data.data_ptr(), plan.rows, data.stride(0), plan.keys.data_ptr(),
        plan.order.data_ptr(), n, delta.data_ptr(), d, float(sign),
        slot_keys.data_ptr(), slot_vals.data_ptr(), cap_a,
        stream_of(data)), what)


def _check_scatter(data: torch.Tensor, ids: torch.Tensor,
                   delta: torch.Tensor) -> None:
    if delta.dim() != 2 or delta.shape[0] > ids.numel():
        raise ValueError(f"delta {tuple(delta.shape)} needs [k, d] with "
                         f"k <= {ids.numel()} ids")
    if delta.shape[1] > data.shape[1]:
        raise ValueError(f"delta width {delta.shape[1]} exceeds the "
                         f"table width {data.shape[1]}")


def row_scatter_add(data: torch.Tensor, ids: torch.Tensor,
                    delta: torch.Tensor, sign: float = 1.0, *,
                    distinct: bool = False) -> None:
    """K3: scatter-add ``sign * delta`` [k, d] into the rows ``ids`` of
    ``data`` [R, S] in place (d <= S; ids past k add zero). Duplicate
    ids sum, in the same order on every run. ``distinct``: the caller
    vouches that the in-range ids strictly ascend (no sort; the plain
    version CHECKs it)."""
    _check_scatter(data, ids, delta)
    if is_plain(data):
        row_scatter_add_plain(data, ids, delta, sign, distinct)
        return
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    require(delta, "delta", torch.float32, data.device, 2)
    if distinct:
        lib = build.library()
        build.check(lib.mv_row_scatter_add_distinct(
            data.data_ptr(), data.shape[0], data.stride(0), ids.data_ptr(),
            delta.shape[0], delta.data_ptr(), delta.shape[1], float(sign),
            stream_of(data)), "row_scatter_add")
    else:
        _scatter_sorted(data, scatter_plan(ids, delta.shape[0],
                                           data.shape[0]),
                        delta, sign, "row_scatter_add")
    row_scatter_add.launches += 1


row_scatter_add.launches = 0


def _windowed(ids: torch.Tensor, ofs: int, n: int):
    """(int64 local rows ``id - ofs``, in-window mask) of global ids."""
    local = ids.reshape(-1).to(torch.int64) - ofs
    return local, (local >= 0) & (local < n)


def _check_window(data: torch.Tensor, ofs: int, n: int) -> None:
    if ofs < 0 or not 0 <= n <= data.shape[0]:
        raise ValueError(f"window [{ofs}, {ofs} + {n}) does not fit a "
                         f"table of {data.shape[0]} rows")


def row_gather_bounded_plain(data: torch.Tensor, ids: torch.Tensor,
                             ofs: int, n: int, n_col: int) -> torch.Tensor:
    """Plain version of K15: ``out[i] = data[ids[i] - ofs, :n_col]`` for
    the ids in ``[ofs, ofs + n)``, zero rows for every other id."""
    local, ok = _windowed(ids, ofs, n)
    rows = data.index_select(0, torch.where(ok, local, 0))[:, :n_col]
    out = torch.where(ok[:, None], rows, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))
    return out.reshape(*ids.shape, n_col)


def row_gather_bounded(data: torch.Tensor, ids: torch.Tensor, ofs: int,
                       n: int, n_col: int) -> torch.Tensor:
    """K15: gather the rows of the global ``ids`` that fall in this
    shard's window ``[ofs, ofs + n)`` (local row ``id - ofs``; zeros for
    the others) into a new ``ids.shape + (n_col,)`` tensor. ``data`` is
    float32 [R, S], n <= R, S >= n_col; ``ids`` int32 on its device."""
    _check_window(data, ofs, n)
    if is_plain(data):
        return row_gather_bounded_plain(data, ids, ofs, n, n_col)
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    if not 0 < n_col <= data.shape[1]:
        raise ValueError(f"n_col {n_col} outside (0, {data.shape[1]}]")
    k = ids.numel()
    out = torch.empty((k, n_col), dtype=torch.float32, device=data.device)
    lib = build.library()
    build.check(lib.mv_row_gather_bounded(
        data.data_ptr(), data.shape[0], data.stride(0), ids.data_ptr(), k,
        out.data_ptr(), n_col, ofs, n, stream_of(data)),
        "row_gather_bounded")
    row_gather_bounded.launches += 1
    return out.reshape(*ids.shape, n_col)


row_gather_bounded.launches = 0


def row_scatter_add_bounded_plain(data: torch.Tensor, ids: torch.Tensor,
                                  delta: torch.Tensor, ofs: int, n: int,
                                  sign: float = 1.0) -> None:
    """Plain version of K16: ``data[ids[i] - ofs, :d] += sign *
    delta[i]`` for the first ``delta.shape[0]`` ids that fall in ``[ofs,
    ofs + n)``, in place; every other id is dropped."""
    k_delta, d_cols = delta.shape
    local, ok = _windowed(ids.reshape(-1)[:k_delta], ofs, n)
    src = delta[ok]
    if sign < 0:
        src = -src
    add_rows(data[:, :d_cols], local[ok], src)


def row_scatter_add_bounded(data: torch.Tensor, ids: torch.Tensor,
                            delta: torch.Tensor, ofs: int, n: int,
                            sign: float = 1.0) -> None:
    """K16: scatter-add ``sign * delta`` [k, d] into this shard's rows
    ``id - ofs`` of ``data`` [R, S] in place, for the global ``ids`` in
    ``[ofs, ofs + n)``; every other id is dropped. Duplicate ids sum, in
    the same order on every run (K3's sorted form)."""
    _check_scatter(data, ids, delta)
    _check_window(data, ofs, n)
    if is_plain(data):
        row_scatter_add_bounded_plain(data, ids, delta, ofs, n, sign)
        return
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    require(delta, "delta", torch.float32, data.device, 2)
    _scatter_sorted(data, scatter_plan(ids, delta.shape[0], data.shape[0],
                                       (ofs, n)),
                    delta, sign, "row_scatter_add_bounded")
    row_scatter_add_bounded.launches += 1


row_scatter_add_bounded.launches = 0
