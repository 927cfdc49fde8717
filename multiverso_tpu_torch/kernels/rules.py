"""K13 row_rule_apply and K14 rows_apply_gather: the updater's row rules.

``row_rule_apply`` (K13) replaces the stateful rules' row updates,
``MomentumRule.rows``, ``AdaGradRule.rows`` and ``DCASGDRule.rows``
(``multiverso_tpu/updater/rules.py:120-125, 144-151, 184-198``), as
``UpdateEngine.apply_rows`` drives them; ``rows_apply_gather`` (K14)
replaces ``UpdateEngine.apply_rows_gather``
(``multiverso_tpu/updater/engine.py:155-193``): any rule's row update,
then the rows ``get_ids`` gathered from the UPDATED table, in one
cooperative launch. Where the caller vouches that the ids ascend (the
engine's host ids), every rule takes one writer an element with no
sort. Otherwise its stateless arm sums repeated ids in K3's fixed order
(the ids sorted stably on the card, ``rows.scatter_plan``, and the
levels of ``rows.scatter_levels`` in the same launch), and its stateful
arms, like K13, walk each row's run of K20's stable sort in position
order: the same bits on every run.

Both follow JAX's semantics: ids in [-R, -1] wrap, for the table and the
state alike; every other out-of-range id (the pad sentinel R among them)
is dropped and gathers a zero row; float32 subnormals flush on every
operation's inputs and result (``flush``). An id that repeats takes its step
from the rows and state as they were before the call, every step lands
on the table and the state row keeps the LAST occurrence's value. A
worker at or past the state's slots reads zero state and its state
writes are dropped. The delta ``[k, d]`` is zero-extended in rows; only
its ``d`` columns are touched.

``hyp`` is the ``AddOption.hyper_array()`` float32 ``[momentum, lr,
rho, lambda]``. On a CUDA tensor each wrapper launches its kernel
(``csrc/row_rules.cu``; both bound by bytes) after sorting the ids
stably by row on the card (K20 ``keysort.key_sort`` or
``rows.scatter_plan``, no host sync; K14's distinct form sorts
nothing), or raises; on a
CPU tensor it runs the plain version beside it. ``row_rule_apply.
launches`` and ``rows_apply_gather.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from ._launch import is_plain, require, stream_of
from .flush import add_rows, flush, fma
from .keysort import key_sort
from .rows import (_check_distinct, _wrapped, level_slots, row_gather_plain,
                   row_scatter_add_plain, scatter_plan)

#: The rule codes of ``csrc/row_rules.cu``.
RULE_CODES = {"default": 0, "sgd": 1, "momentum": 2, "adagrad": 3,
              "dcasgd": 4}
STATEFUL = ("momentum", "adagrad", "dcasgd")
ADAGRAD_EPS = 1e-6  # ref: adagrad_updater.h:18


def safe_lr(lr) -> np.float32:
    """``max(lr, 1e-12)`` in float32: the rules that recover the gradient
    as delta/lr must not turn ``learning_rate=0`` into inf or NaN."""
    return np.maximum(np.float32(lr), np.float32(1e-12))


def scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device. (A CUDA division by a
    Python scalar may become a multiplication by its reciprocal.)"""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=like.device)


def inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` in float32 as two correctly rounded operations —
    K13's and K14's ``__fdiv_rn(1, __fsqrt_rn(x))``. The square root is
    taken in float64 and rounded once to float32, which is the correctly
    rounded float32 root (53 >= 2 * 24 + 2 bits: the double rounding is
    innocuous); ``torch.sqrt`` of a float32 CPU tensor is not correctly
    rounded for some inputs, nor is ``torch.rsqrt`` on either device."""
    root = torch.sqrt(x.double()).to(x.dtype)
    return scalar(1, x) / root


#: The widest rows (storage columns) at which the reference's momentum row
#: programs fuse the other product in the last column: of the step added
#: to the table, and of the state written back.
MOMENTUM_STEP_SWAP_WIDTH, MOMENTUM_STATE_SWAP_WIDTH = 29, 33


def momentum_swap_cols(width: int) -> Tuple[int, int]:
    """The columns of a momentum row update over rows of ``width``
    storage columns where the reference's ``apply_rows`` and
    ``apply_rows_gather`` fuse ``(1 - m) * d`` into the add (``m * s``
    rounded), not ``m * s``: (in the step added to the table, in the
    state written back), each the last column or none (-1). XLA's CPU
    backend unrolls the column loop of narrow rows, and the last
    column's fused multiply-add is shared with the branch of an
    out-of-range id, whose gathered state is zero; wider rows run a
    vector loop that fuses ``m * s`` in every column. The program forms
    the step and the state apart, and the two loops differ: the step's
    last column swaps at rows up to 29 floats, the state's up to 33
    (ROADMAP C13; found by holding both forms against the reference's
    programs at widths 20-41 over tables of 48-1,000 rows, 1 and 8
    devices; ``tests/test_torch_k14_stateful.py`` holds 29, 30, 33 and
    34)."""
    last = width - 1
    return (last if width <= MOMENTUM_STEP_SWAP_WIDTH else -1,
            last if width <= MOMENTUM_STATE_SWAP_WIDTH else -1)


def _swapped(smooth: torch.Tensor, col: int, one_m, m, dv, s0):
    """``smooth`` with column ``col`` (if any) formed as ``fma(1 - m, d,
    m * s)``."""
    if not 0 <= col < dv.shape[-1]:
        return smooth
    out = smooth.clone()
    c = slice(col, col + 1)
    out[..., c] = fma(one_m, dv[..., c], flush(m * s0[..., c]))
    return out


def rule_step(rule: str, hyp, x0: torch.Tensor, s0: torch.Tensor,
              dv: torch.Tensor, swap: Tuple[int, int] = (-1, -1)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(step subtracted from the table, new state) of a stateful rule's
    row update, elementwise, in the reference's expression order, every
    operation flushed on its inputs and its result (``flush``), and a
    product fused into the add that follows it (``fma``) exactly where
    the reference's ``apply_rows`` contracts it (ROADMAP C13, pinned by
    ``tests/test_torch_fma.py``): momentum's ``m * s`` (``(1 - m) * d``
    in the columns ``swap`` of the last axis, ``momentum_swap_cols``),
    AdaGrad's ``g * g`` and DCASGD's compensation term."""
    m, lr, rho, lam = (np.float32(v) for v in hyp)
    f = flush
    x0, s0, dv = f(x0), f(s0), f(dv)
    if rule == "momentum":
        one_m, mm = scalar(np.float32(1) - m, dv), scalar(m, dv)
        smooth = fma(mm, s0, f(one_m * dv))
        return (_swapped(smooth, swap[0], one_m, mm, dv, s0),
                _swapped(smooth, swap[1], one_m, mm, dv, s0))
    grad = f(dv / scalar(safe_lr(lr), dv))
    if rule == "adagrad":
        g_sqr = fma(grad, grad, s0)
        step = f(f(scalar(rho, dv) * grad) * inv_sqrt(
            f(g_sqr + scalar(ADAGRAD_EPS, dv))))
        return step, g_sqr
    lr_lam = f(scalar(lr, dv) * scalar(lam, dv))
    step = fma(f(f(lr_lam * grad) * grad), f(x0 - s0), dv)
    return step, f(x0 - step)


def _check_state(rule: str, state, stateful: bool = False) -> None:
    """A stateful rule comes with its state, a stateless one keeps none;
    K13 (``stateful``) takes only the stateful rules — K3 adds the
    others' rows."""
    if rule not in (STATEFUL if stateful else RULE_CODES):
        raise ValueError(f"rule {rule!r}: expected one of "
                         f"{STATEFUL if stateful else tuple(RULE_CODES)}")
    if (rule in STATEFUL) != (state is not None):
        raise ValueError(f"rule {rule!r} with state {state is not None}")


def _check_rows(data, ids, delta) -> None:
    if delta.dim() != 2 or delta.shape[0] > ids.numel():
        raise ValueError(f"delta {tuple(delta.shape)} needs [k, d] with "
                         f"k <= {ids.numel()} ids")
    if data.dim() != 2 or delta.shape[1] > data.shape[1]:
        raise ValueError(f"delta width {delta.shape[1]} exceeds the table "
                         f"width {data.shape[1]}")


def _state_rows(rule: str, state: torch.Tensor, worker_id: int):
    """The state a worker's rows read and write: momentum's table-shaped
    state, the worker's slot of a per-worker state, or None for a worker
    past the slots (reads zero, writes dropped)."""
    if rule == "momentum":
        return state
    return state[worker_id] if worker_id < state.shape[0] else None


def row_rule_apply_plain(rule: str, data: torch.Tensor,
                         state: torch.Tensor, ids: torch.Tensor,
                         delta: torch.Tensor, hyp,
                         worker_id: int) -> None:
    """Plain version of K13, in place on ``data`` and ``state``."""
    _check_state(rule, state, stateful=True)
    _check_rows(data, ids, delta)
    k, d = delta.shape
    flat, ok = _wrapped(ids, data.shape[0])
    n = flat.numel()
    dv = torch.zeros((n, d), dtype=data.dtype, device=data.device)
    dv[:k] = delta
    safe = torch.where(ok, flat, 0)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    x0 = torch.where(ok[:, None], data.index_select(0, safe)[:, :d], zero)
    rows_state = _state_rows(rule, state, worker_id)
    s0 = torch.zeros_like(x0) if rows_state is None else torch.where(
        ok[:, None], rows_state.index_select(0, safe)[:, :d], zero)
    swap = momentum_swap_cols(data.shape[1]) if rule == "momentum" \
        else (-1, -1)
    step, s_new = rule_step(rule, hyp, x0, s0, dv, swap)
    add_rows(data[:, :d], flat[ok], -step[ok])
    if rows_state is None:
        return
    # The state row keeps its last occurrence's value.
    pos = torch.arange(n, device=data.device)[ok]
    target = flat[ok]
    last = torch.full((data.shape[0],), -1, dtype=torch.int64,
                      device=data.device)
    last.scatter_reduce_(0, target, pos, "amax")
    keep = last[target] == pos
    rows_state[:, :d].index_copy_(0, target[keep], s_new[pos[keep]])


def _launch_args(rule: str, data, state, ids, delta, hyp, worker_id):
    m, lr, rho, lam = (float(np.float32(v)) for v in hyp)
    require(data, "data", torch.float32, data.device, 2)
    require(ids, "ids", torch.int32, data.device)
    require(delta, "delta", torch.float32, data.device, 2)
    workers = 0
    if state is not None:
        require(state, "state", torch.float32, data.device,
                2 if rule == "momentum" else 3)
        if tuple(state.shape[-2:]) != tuple(data.shape):
            raise ValueError(f"state {tuple(state.shape)} does not match "
                             f"the table {tuple(data.shape)}")
        workers = 1 if rule == "momentum" else state.shape[0]
    swap = momentum_swap_cols(data.shape[1]) if rule == "momentum" \
        else (-1, -1)
    return (RULE_CODES[rule], data.data_ptr(), data.shape[0],
            data.stride(0), None if state is None else state.data_ptr(),
            workers, min(int(worker_id), 2 ** 31 - 1)), \
        (m, lr, rho, lam, *swap)


def row_rule_apply(rule: str, data: torch.Tensor, state: torch.Tensor,
                   ids: torch.Tensor, delta: torch.Tensor, hyp,
                   worker_id: int) -> None:
    """K13: a stateful rule's row update of ``data`` [R, S] and its
    ``state`` (momentum ``[R, S]``, adagrad and dcasgd ``[W, R, S]``) in
    place, for the int32 ``ids`` [n] and the delta [k, d], k <= n,
    d <= S."""
    _check_state(rule, state, stateful=True)
    _check_rows(data, ids, delta)
    if is_plain(data):
        row_rule_apply_plain(rule, data, state, ids, delta, hyp, worker_id)
        return
    head, hyps = _launch_args(rule, data, state, ids, delta, hyp, worker_id)
    keys, order = key_sort(ids, data.shape[0])
    lib = build.library()
    build.check(lib.mv_row_rule_apply(
        *head, keys.data_ptr(), order.data_ptr(), keys.numel(),
        delta.data_ptr(), delta.shape[0], delta.shape[1], *hyps,
        stream_of(data)), "row_rule_apply")
    row_rule_apply.launches += 1


row_rule_apply.launches = 0


def rule_apply_distinct_plain(rule: str, data: torch.Tensor,
                              state: torch.Tensor, ids: torch.Tensor,
                              delta: torch.Tensor, hyp,
                              worker_id: int) -> None:
    """Plain version of K14's distinct stateful form, in place: the
    in-range ids strictly ascend (CHECKed, as K3's plain version checks
    the claim), so each touched element takes one step, written once,
    and its state once — the same operations, bit for bit, as
    ``row_rule_apply_plain`` on such ids."""
    _check_rows(data, ids, delta)
    _check_distinct(ids, ids.numel(), data.shape[0])
    k, d = delta.shape
    flat, ok = _wrapped(ids, data.shape[0])
    rows = flat[ok]
    pos = torch.arange(flat.numel(), device=data.device)[ok]
    dv = torch.zeros((rows.numel(), d), dtype=data.dtype, device=data.device)
    has = pos < k
    dv[has] = delta[pos[has]]
    x0 = data.index_select(0, rows)[:, :d]
    rows_state = _state_rows(rule, state, worker_id)
    s0 = torch.zeros_like(x0) if rows_state is None \
        else rows_state.index_select(0, rows)[:, :d]
    swap = momentum_swap_cols(data.shape[1]) if rule == "momentum" \
        else (-1, -1)
    step, s_new = rule_step(rule, hyp, x0, s0, dv, swap)
    data[:, :d].index_copy_(0, rows, flush(flush(x0) - step))
    if rows_state is not None:
        rows_state[:, :d].index_copy_(0, rows, s_new)


def rows_apply_gather_plain(rule: str, data: torch.Tensor,
                            state: Optional[torch.Tensor], ids: torch.Tensor,
                            delta: torch.Tensor, hyp, worker_id: int,
                            get_ids: torch.Tensor, n_col: int,
                            distinct: bool = False) -> torch.Tensor:
    """Plain version of K14: the rule's row update (K3's or K13's plain
    version, or with ``distinct`` the stateful rules' distinct form),
    then ``row_gather_plain`` of the updated table. ``distinct``: CHECK
    the claim, as K3's plain version does."""
    if rule in STATEFUL and distinct:
        rule_apply_distinct_plain(rule, data, state, ids, delta, hyp,
                                  worker_id)
    elif rule in STATEFUL:
        row_rule_apply_plain(rule, data, state, ids, delta, hyp, worker_id)
    else:
        _check_rows(data, ids, delta)
        row_scatter_add_plain(data, ids, delta,
                              -1.0 if rule == "sgd" else 1.0, distinct)
    return row_gather_plain(data, get_ids, n_col)


def rows_apply_gather(rule: str, data: torch.Tensor,
                      state: Optional[torch.Tensor], ids: torch.Tensor,
                      delta: torch.Tensor, hyp, worker_id: int,
                      get_ids: torch.Tensor, n_col: int, *,
                      distinct: bool = False) -> torch.Tensor:
    """K14: ``rule``'s row update of ``data`` (and ``state``) in place,
    then ``data[get_ids, :n_col]`` of the updated table as a new
    ``[len(get_ids), n_col]`` tensor — one cooperative launch with a
    grid-wide barrier between the two. With ``distinct`` — the caller
    vouches that the in-range ids strictly ascend — every rule takes one
    writer an element with no sort. Otherwise a stateless rule sums
    repeated ids in K3's order (the sorted form;
    ``rows.row_scatter_add_ordered`` bit for bit) and a stateful rule
    walks each row's run of K20's sort (``keysort.key_sort``) in position
    order, a warp on the runs whose heads a tile of 32 sorted positions
    holds."""
    _check_state(rule, state)
    _check_rows(data, ids, delta)
    if not 0 < n_col <= data.shape[1]:
        raise ValueError(f"n_col {n_col} outside (0, {data.shape[1]}]")
    stateless = rule not in STATEFUL
    if is_plain(data):
        return rows_apply_gather_plain(rule, data, state, ids, delta, hyp,
                                       worker_id, get_ids, n_col, distinct)
    head, hyps = _launch_args(rule, data, state, ids, delta, hyp, worker_id)
    require(get_ids, "get_ids", torch.int32, data.device)
    keys = order = slot_keys = slot_vals = None
    n, cap_a = ids.numel(), 0
    if distinct:
        pass
    elif not stateless:
        keys, order = key_sort(ids, data.shape[0])
    else:
        plan = scatter_plan(ids, delta.shape[0], data.shape[0])
        keys, order, n = plan.keys, plan.order, plan.keys.numel()
        slot_keys, slot_vals, cap_a = level_slots(n, delta.shape[1],
                                                  data.device)
    out = torch.empty((get_ids.numel(), n_col), dtype=torch.float32,
                      device=data.device)
    lib = build.library()
    build.check(lib.mv_rows_apply_gather(
        *head, ids.data_ptr(), None if keys is None else keys.data_ptr(),
        None if order is None else order.data_ptr(), n,
        delta.data_ptr(), delta.shape[0], delta.shape[1], *hyps,
        get_ids.data_ptr(), get_ids.numel(), out.data_ptr(), n_col,
        int(distinct), None if slot_keys is None else slot_keys.data_ptr(),
        None if slot_vals is None else slot_vals.data_ptr(), cap_a,
        stream_of(data)), "rows_apply_gather")
    rows_apply_gather.launches += 1
    return out


rows_apply_gather.launches = 0
