"""Table factory: create worker+server table pairs by rank role.

Port of ``multiverso_tpu/tables/factory.py`` (ref: include/multiverso/
table_factory.h:16-26, src/table_factory.cpp:8-22, include/multiverso/
multiverso.h:35-41): on a server rank the server-side shard is created
first, then the worker handle on worker ranks, followed by a barrier so
every rank sees consistent table ids. Array tables are a later item of
the port (ROADMAP A6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.node import is_server, is_worker
from ..runtime.zoo import current_zoo
from .kv_table import KVServer, KVWorker
from .matrix_table import MatrixServer, MatrixTableOption, MatrixWorker


def _table_role(zoo) -> int:
    if not zoo._nodes:
        raise RuntimeError("no parameter server on this rank")
    return zoo._nodes[zoo.rank].role


@dataclass
class KVTableOption:
    key_dtype: object = np.int64
    val_dtype: object = np.float32


def create_matrix_table(num_row: int, num_col: int, dtype=np.float32,
                        is_sparse: bool = False, is_pipeline: bool = False,
                        updater_type: Optional[str] = None,
                        random_init: Optional[tuple] = None, seed: int = 0,
                        zoo=None) -> Optional[MatrixWorker]:
    zoo = zoo if zoo is not None else current_zoo()
    role = _table_role(zoo)
    worker = None
    if is_server(role):
        MatrixServer(num_row, num_col, dtype, is_sparse=is_sparse,
                     is_pipeline=is_pipeline, zoo=zoo,
                     updater_type=updater_type, random_init=random_init,
                     seed=seed)
    if is_worker(role):
        worker = MatrixWorker(num_row, num_col, dtype, is_sparse=is_sparse,
                              is_pipeline=is_pipeline, zoo=zoo,
                              updater_type=updater_type)
    zoo.barrier()
    return worker


def create_kv_table(key_dtype=np.int64, val_dtype=np.float32,
                    zoo=None) -> Optional[KVWorker]:
    zoo = zoo if zoo is not None else current_zoo()
    role = _table_role(zoo)
    worker = None
    if is_server(role):
        KVServer(key_dtype, val_dtype, zoo=zoo)
    if is_worker(role):
        worker = KVWorker(key_dtype, val_dtype, zoo=zoo)
    zoo.barrier()
    return worker


def create_array_table(*args, **kwargs):
    raise NotImplementedError("array tables are not ported yet "
                              "(ROADMAP A6)")


def create_table(option, zoo=None):
    """Dispatch on an option struct (the reference's templated
    MV_CreateTable, ref: multiverso.h:35-41)."""
    if isinstance(option, MatrixTableOption):
        return create_matrix_table(option.num_row, option.num_col,
                                   option.dtype, option.is_sparse,
                                   option.is_pipeline, option.updater_type,
                                   zoo=zoo)
    if isinstance(option, KVTableOption):
        return create_kv_table(option.key_dtype, option.val_dtype, zoo=zoo)
    raise NotImplementedError(f"{type(option).__name__}: not ported yet "
                              f"(ROADMAP A6)")
