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
bytes — one warp per row, 16-byte accesses) or raises; on a CPU tensor
it runs the plain version beside it. Each wrapper's ``launches`` counts
its kernel launches.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import is_plain, require, stream_of


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


def row_scatter_add_plain(data: torch.Tensor, ids: torch.Tensor,
                          delta: torch.Tensor, sign: float = 1.0) -> None:
    """Plain version of K3: ``data[ids[i], :d] += sign * delta[i]`` for
    the first ``delta.shape[0]`` ids, in place; out-of-range ids are
    masked out BEFORE ``index_add_``, which raises on them."""
    k_delta, d_cols = delta.shape
    flat, ok = _wrapped(ids.reshape(-1)[:k_delta], data.shape[0])
    src = delta[ok]
    if sign < 0:
        src = -src
    data[:, :d_cols].index_add_(0, flat[ok], src)


def row_scatter_add(data: torch.Tensor, ids: torch.Tensor,
                    delta: torch.Tensor, sign: float = 1.0) -> None:
    """K3: scatter-add ``sign * delta`` [k, d] into the rows ``ids`` of
    ``data`` [R, S] in place (d <= S; ids past k add zero). Duplicate
    ids sum, in an order that varies from run to run on the card."""
    if delta.dim() != 2 or delta.shape[0] > ids.numel():
        raise ValueError(f"delta {tuple(delta.shape)} needs [k, d] with "
                         f"k <= {ids.numel()} ids")
    if delta.shape[1] > data.shape[1]:
        raise ValueError(f"delta width {delta.shape[1]} exceeds the "
                         f"table width {data.shape[1]}")
    if is_plain(data):
        row_scatter_add_plain(data, ids, delta, sign)
        return
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    require(delta, "delta", torch.float32, data.device, 2)
    lib = build.library()
    build.check(lib.mv_row_scatter_add(
        data.data_ptr(), data.shape[0], data.stride(0), ids.data_ptr(),
        delta.shape[0], delta.data_ptr(), delta.shape[1], float(sign),
        stream_of(data)), "row_scatter_add")
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
    data[:, :d_cols].index_add_(0, local[ok], src)


def row_scatter_add_bounded(data: torch.Tensor, ids: torch.Tensor,
                            delta: torch.Tensor, ofs: int, n: int,
                            sign: float = 1.0) -> None:
    """K16: scatter-add ``sign * delta`` [k, d] into this shard's rows
    ``id - ofs`` of ``data`` [R, S] in place, for the global ``ids`` in
    ``[ofs, ofs + n)``; every other id is dropped. Duplicate ids sum, in
    an order that varies from run to run on the card."""
    if delta.dim() != 2 or delta.shape[0] > ids.numel():
        raise ValueError(f"delta {tuple(delta.shape)} needs [k, d] with "
                         f"k <= {ids.numel()} ids")
    if delta.shape[1] > data.shape[1]:
        raise ValueError(f"delta width {delta.shape[1]} exceeds the "
                         f"table width {data.shape[1]}")
    _check_window(data, ofs, n)
    if is_plain(data):
        row_scatter_add_bounded_plain(data, ids, delta, ofs, n, sign)
        return
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    require(delta, "delta", torch.float32, data.device, 2)
    lib = build.library()
    build.check(lib.mv_row_scatter_add_bounded(
        data.data_ptr(), data.shape[0], data.stride(0), ids.data_ptr(),
        delta.shape[0], delta.data_ptr(), delta.shape[1], float(sign), ofs,
        n, stream_of(data)), "row_scatter_add_bounded")
    row_scatter_add_bounded.launches += 1


row_scatter_add_bounded.launches = 0
