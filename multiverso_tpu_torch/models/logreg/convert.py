"""Carry logistic-regression weights from the JAX reference into the port.

``load_reference_weights(model, w)`` writes a reference model's
``weights`` (a numpy array ``[input_size(+1), max(output_size, 1)]``)
into a port ``LocalModel`` or ``PSModel``; ``load_reference_ftrl(model,
z, n)`` writes an FTRL model's state (the reference's ``_z``/``_n``).
For the PS models the server tables receive the same values through
their ``load`` (the reference's raw float32 byte format, so the values
land bit for bit) and the local replica is set alongside, so both
packages compute from the same state.

A model file needs no conversion: both packages ``store`` raw float32
``[input_size(+1), max(output_size, 1)]``, z then n for FTRL, and each
``load``s the other's.

Setup-time only: call it with no table request in flight.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ...util.log import CHECK


def _load_table(table, values: np.ndarray) -> None:
    table.zoo.server_tables[table.table_id].load(
        io.BytesIO(np.ascontiguousarray(values, np.float32).tobytes()))


def load_reference_weights(model, w: np.ndarray) -> None:
    w = np.array(w, np.float32)
    shape = tuple(model._w.shape)
    CHECK(w.size == int(np.prod(shape)),
          f"weights {w.shape} do not fit the model's {shape}")
    w = w.reshape(shape)
    table = getattr(model, "_table", None)
    if table is not None:
        _load_table(table, w)
    model._w = torch.from_numpy(w).to(model._w.device)


def load_reference_ftrl(model, z: np.ndarray, n: np.ndarray) -> None:
    model.load_state(z, n)
    if model._use_ps:
        _load_table(model._z_table, np.asarray(z))
        _load_table(model._n_table, np.asarray(n))
