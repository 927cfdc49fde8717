"""Wire-serialized per-request hyperparameter structs.

Bit-compatible with the reference's ``AddOption``/``GetOption``
(ref: include/multiverso/updater/updater.h:10-110): a flat array of 4-byte
slots, each read as int32 or float32 —

- AddOption: [worker_id:i32, momentum:f32, learning_rate:f32, rho:f32,
  lambda:f32]
- GetOption: [worker_id:i32]

They ride as an extra trailing blob on Add/Get messages and are parsed
server-side (ref: src/table/matrix_table.cpp:392-395).
"""

from __future__ import annotations

import numpy as np

from ..core.blob import Blob


class AddOption:
    __slots__ = ("worker_id", "momentum", "learning_rate", "rho", "lambda_")
    NUM_SLOTS = 5

    def __init__(self, worker_id: int = 0, momentum: float = 0.0,
                 learning_rate: float = 0.01, rho: float = 0.1,
                 lambda_: float = 0.1):
        self.worker_id = int(worker_id)
        self.momentum = float(momentum)
        self.learning_rate = float(learning_rate)
        self.rho = float(rho)
        self.lambda_ = float(lambda_)

    def to_blob(self) -> Blob:
        raw = np.empty(self.NUM_SLOTS, dtype=np.float32)
        raw.view(np.int32)[0] = self.worker_id
        raw[1] = self.momentum
        raw[2] = self.learning_rate
        raw[3] = self.rho
        raw[4] = self.lambda_
        return Blob(raw.view(np.uint8))

    @classmethod
    def from_blob(cls, blob: Blob) -> "AddOption":
        raw = blob.as_array(np.float32)
        opt = cls()
        opt.worker_id = int(raw.view(np.int32)[0])
        opt.momentum = float(raw[1])
        opt.learning_rate = float(raw[2])
        opt.rho = float(raw[3])
        opt.lambda_ = float(raw[4])
        return opt

    def hyper_array(self) -> np.ndarray:
        """[momentum, lr, rho, lambda] as a jit argument (not static, so
        hyperparameter changes never retrace)."""
        return np.array([self.momentum, self.learning_rate,
                         self.rho, self.lambda_], dtype=np.float32)

    def __repr__(self) -> str:
        return (f"AddOption(worker_id={self.worker_id}, "
                f"momentum={self.momentum}, lr={self.learning_rate}, "
                f"rho={self.rho}, lambda={self.lambda_})")


class GetOption:
    __slots__ = ("worker_id",)
    NUM_SLOTS = 1

    def __init__(self, worker_id: int = 0):
        self.worker_id = int(worker_id)

    def to_blob(self) -> Blob:
        return Blob(np.array([self.worker_id], dtype=np.int32).view(np.uint8))

    @classmethod
    def from_blob(cls, blob: Blob) -> "GetOption":
        return cls(worker_id=int(blob.as_array(np.int32)[0]))

    def __repr__(self) -> str:
        return f"GetOption(worker_id={self.worker_id})"
