"""Distributed tables: torch tensor state behind the PS Get/Add API."""

from .factory import (KVTableOption, create_array_table,  # noqa: F401
                      create_kv_table, create_matrix_table, create_table)
from .kv_table import KVServer, KVWorker  # noqa: F401
from .matrix_table import (MatrixServer, MatrixTableOption,  # noqa: F401
                           MatrixWorker, row_offsets)
from .table_interface import ServerTable, WorkerTable  # noqa: F401
