"""Distributed tables: torch tensor state behind the PS Get/Add API."""

from .array_table import ArrayServer, ArrayWorker  # noqa: F401
from .factory import (ArrayTableOption, KVTableOption,  # noqa: F401
                      create_array_table, create_kv_table,
                      create_matrix_table, create_table)
from .kv_table import KVServer, KVWorker  # noqa: F401
from .matrix_table import (MatrixServer, MatrixTableOption,  # noqa: F401
                           MatrixWorker, row_offsets)
from .table_interface import ServerTable, WorkerTable  # noqa: F401
