"""Carry word2vec weights from the JAX reference into the port.

``load_reference_tables`` writes given input/output rows into a
``PSWord2Vec``'s two matrix tables through the tables' ``load`` — the
reference's ``store`` byte format (raw row-major logical rows), so the
values land bit for bit. The rows come as numpy arrays, e.g. from the
reference's ``table.get()``; a ``store`` stream written by the
reference loads the same way through ``MatrixServer.load``.

Setup-time only: call it with no table request in flight.
"""

from __future__ import annotations

import io

import numpy as np

from ...util.log import CHECK


def load_reference_tables(model, in_rows: np.ndarray,
                          out_rows: np.ndarray) -> None:
    model._drain_pushes()
    zoo = model._in_table.zoo
    for worker, rows in ((model._in_table, in_rows),
                         (model._out_table, out_rows)):
        rows = np.ascontiguousarray(rows, dtype=worker.dtype)
        CHECK(rows.shape == (worker.num_row, worker.num_col),
              f"rows {rows.shape} do not fit table {worker.table_id} "
              f"({worker.num_row}, {worker.num_col})")
        zoo.server_tables[worker.table_id].load(io.BytesIO(rows.tobytes()))
