"""LogReg models: local, parameter-server, and FTRL.

Port of ``multiverso_tpu/models/logreg/model.py`` (ref:
Applications/LogisticRegression/src/model/model.cpp, model/ps_model.cpp).
One step a minibatch: for sparse input the kernels K11 and K12
(``objective.SparseStep``) score the batch and update the touched rows
in place — the reference's jitted forward, backward and update with
its donated buffers; for dense input torch matmuls around K21 and the
update formed as the reference's programs form it (ROADMAP C14). The PS
variant keeps the reference's structure — pull every
``sync_frequency`` minibatches (ref: ps_model.cpp:236-271), push
lr-scaled deltas (ref: ps_model.cpp:185-203, updater.cpp:55-70) that
the server's sgd updater subtracts — with tensor payloads through the
in-process tables.

FTRL-proximal (ref: updater/ftrl_updater.h, util/ftrl_sparse_table.h)
keeps per-weight state z (signed accumulator) and n (squared-gradient
sum); the PS form pushes (delta_z, delta_n) to two array tables with
the default adder, the reference's FTRL gradient wire format
{delta_z, delta_n} (ref: util/data_type.h:13-54).

``LocalModel`` and the local ``FTRLModel`` live on ``device``
(``cuda:0`` by default, raising without a card; the CPU only when the
caller passes ``device="cpu"``); the PS models live on the zoo's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import create_array_table, create_matrix_table
from ...kernels.flush import flush as f
from ...kernels.flush import fma, sqrt
from ...kernels.logreg import SettleFlag, ftrl_weights
from ...runtime.zoo import current_zoo, resolve_device
from ...util.log import CHECK
from .config import Configure
from .objective import (ftrl_params, learning_rate, make_dense_step,
                        make_predict, make_sparse_step)
from .reader import Batch


def _weight_shape(config: Configure):
    rows = config.input_size + (1 if config.sparse else 0)
    return (rows, max(config.output_size, 1))


def _args(batch: Batch, device: torch.device):
    """The batch as tensors on ``device``: ``(x, labels, weights)`` dense,
    ``(keys, values, labels, weights)`` sparse. Keys go to int32 as JAX
    casts them (two's-complement truncation)."""
    labels = torch.from_numpy(batch.labels).to(device)
    weights = torch.from_numpy(batch.weights).to(device)
    if batch.x is not None:
        return (torch.from_numpy(batch.x).to(device), labels, weights)
    return (torch.from_numpy(batch.keys.astype(np.int32)).to(device),
            torch.from_numpy(batch.values).to(device), labels, weights)


def _lr(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device (the reference passes the
    learning rate as a float32 argument)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _reg_keeps_plus(config: Configure) -> bool:
    """Whether the reference's untouched rows settle to +0, not to a
    flushed zero of their sign (``SettleFlag.plus``): the dense
    update there is ``+0 * reg(w)``, a zero of ``w``'s sign (times the
    coefficient's), and ``w - z`` for a zero ``z`` of ``w``'s sign is
    +0."""
    return config.regular_type in ("L1", "L2") and \
        not np.signbit(np.float32(config.regular_coef))


def _settle_flag(config: Configure, device) -> Optional[SettleFlag]:
    """The flag by which a sparse model's next step settles its untouched
    rows (ROADMAP C12), to +0 under a regularizer that keeps +0
    (``_reg_keeps_plus``) and in FTRL's state; None for dense models."""
    if not config.sparse:
        return None
    ftrl = config.objective_type == "ftrl" or config.updater_type == "ftrl"
    return SettleFlag(device, ftrl or _reg_keeps_plus(config))


def _read_rows(stream, shape) -> np.ndarray:
    raw = stream.read(int(np.prod(shape)) * 4)
    return np.frombuffer(raw, np.float32).reshape(shape)


class LocalModel:
    """Single-process model: weights live on the device, one step a batch
    (ref: model/model.cpp:63-110)."""

    def __init__(self, config: Configure, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._w = torch.zeros(_weight_shape(config), dtype=torch.float32,
                              device=self.device)
        self._step = make_sparse_step(config) if config.sparse \
            else make_dense_step(config)
        self._scale_lr = config.updater_type in ("sgd", "ftrl")
        self._predict = make_predict(config)
        self.update_count = 0
        # Weights that come in from outside the step (``load_weights``)
        # are settled by the next sparse step.
        self._settle = _settle_flag(config, self.device)

    def update(self, batch: Batch) -> float:
        lr = learning_rate(self.config, self.update_count)
        args = _args(batch, self.device)
        if self.config.sparse:
            loss_sum = self._step(self._w, *args,
                                  scale=lr if self._scale_lr else 1.0,
                                  settle=self._settle)[0]
        else:
            loss_sum, _, grad = self._step(self._w, *args)
            # The reference's fused program contracts ``w - grad * lr``
            # into one fused multiply-add (ROADMAP C14).
            self._w = fma(-grad, _lr(lr, grad), self._w) if self._scale_lr \
                else f(f(self._w) - grad)
        self.update_count += 1
        return float(loss_sum)

    def predict(self, batch: Batch) -> np.ndarray:
        args = _args(batch, self.device)
        return self._predict(self._w, *args[:-2]).cpu().numpy()

    @property
    def weights(self) -> np.ndarray:
        return self._w.cpu().numpy()

    def load_weights(self, w: np.ndarray) -> None:
        self._w = torch.from_numpy(np.array(w, np.float32).reshape(
            tuple(self._w.shape))).to(self.device)
        if self._settle is not None:
            self._settle.request()

    def store(self, stream) -> None:
        stream.write(self.weights.astype(np.float32).tobytes())

    def load(self, stream) -> None:
        self.load_weights(_read_rows(stream, _weight_shape(self.config)))


class PSModel:
    """Parameter-server model (ref: model/ps_model.cpp:23-271).

    Dense: the whole model in one array table with the sgd server
    updater; pulls ride ``get_device`` and pushes are tensor deltas.
    Sparse: a sparse matrix table whose pulls return only this worker's
    dirty rows, which land in a host copy of the local replica (the
    reference's pull, kept as it is). Pulls happen every
    ``sync_frequency`` minibatches; meanwhile the worker trains on its
    local replica and pushes lr-scaled deltas of the rows it touched,
    the padding row excluded, that the server's sgd updater subtracts
    (ref: ps_model.cpp:172-203, sgd_updater.h:15-19)."""

    def __init__(self, config: Configure):
        self.config = config
        self.device = current_zoo().device
        rows, cols = _weight_shape(config)
        self._w = torch.zeros((rows, cols), dtype=torch.float32,
                              device=self.device)
        if config.sparse:
            self._table = create_matrix_table(
                rows, cols, is_sparse=True, is_pipeline=config.pipeline,
                updater_type="sgd")
        else:
            self._table = create_array_table(rows * cols,
                                             updater_type="sgd")
        self._step = make_sparse_step(config) if config.sparse \
            else make_dense_step(config)
        self._scale_lr = config.updater_type in ("sgd", "ftrl")
        self._predict = make_predict(config)
        self.update_count = 0
        self._batch_count = 0
        # A pull's reply is a copy of the server's rows, which its sgd
        # rule has flushed but whose zeros may be -0: under a
        # regularizer the next sparse step settles its untouched rows
        # to +0.
        self._settle = _settle_flag(config, self.device)
        self._pull()

    # -- pull (ref: ps_model.cpp:172-182) --
    def _pull(self) -> None:
        if self.config.sparse:
            # The dirty rows land in a host copy of the replica (on the
            # CPU this array IS the replica's storage).
            buf = self._w.cpu().numpy()
            self._table.get(out=buf)
            self._w = torch.from_numpy(buf).to(self.device)
            if self._settle.plus:
                self._settle.request()
        else:
            self._w = self._table.get_device().reshape(self._w.shape)

    def update(self, batch: Batch) -> float:
        config = self.config
        lr = learning_rate(config, self.update_count)
        scale = lr if self._scale_lr else 1.0
        args = _args(batch, self.device)
        if config.sparse:
            # The reference pushes its host np.unique of the keys, where
            # a negative key fails the table's row-id check.
            CHECK(int(batch.keys.min()) >= 0,
                  "row ids out of range [0, num_row)")
            loss_sum, _, rows, delta = self._step(
                self._w, *args, scale=scale, delta_rows=True,
                settle=self._settle)
            # Sorted unique rows, on the host (one copy from the card):
            # the server's engine finds them ascending and K3 adds them
            # with one writer a row, no sort.
            rows = rows.numpy()
            pushed = int(np.searchsorted(rows, config.input_size))
            self._table.add_rows_async(rows[:pushed].astype(np.int32),
                                       delta[:pushed])
        else:
            loss_sum, _, grad = self._step(self._w, *args)
            # ``g * lr`` and ``w - delta`` are programs of their own in
            # the reference: each rounds and flushes.
            delta = f(grad * _lr(lr, grad)) if self._scale_lr else grad
            self._table.add_async(delta.reshape(-1))
            # Applied locally too so training continues between pulls.
            self._w = f(f(self._w) - delta)
        self.update_count += 1
        self._batch_count += 1
        if self._batch_count % config.sync_frequency == 0:
            self._pull()
        return float(loss_sum)

    def predict(self, batch: Batch) -> np.ndarray:
        args = _args(batch, self.device)
        return self._predict(self._w, *args[:-2]).cpu().numpy()

    @property
    def weights(self) -> np.ndarray:
        return self._w.cpu().numpy()

    def store(self, stream) -> None:
        stream.write(self.weights.astype(np.float32).tobytes())

    def load_weights(self, loaded: np.ndarray) -> None:
        """Upload into the PS with the negate-add trick: push (current -
        loaded) through the subtracting sgd updater (ref: ps_model.cpp:
        116-169), then pull."""
        shape = _weight_shape(self.config)
        self._pull()
        delta = self.weights - np.asarray(loaded, np.float32).reshape(shape)
        if self.config.sparse:
            self._table.add_rows(np.arange(shape[0], dtype=np.int32), delta)
        else:
            self._table.add(delta.reshape(-1))
        self._pull()

    def load(self, stream) -> None:
        self.load_weights(_read_rows(stream, _weight_shape(self.config)))


class FTRLModel:
    """FTRL-proximal (ref: updater/ftrl_updater.h semantics): per-weight
    state z, n; w derived lazily:
        w = 0                                  if |z| <= lambda1
        w = -(z - sign(z)*lambda1) / ((beta + sqrt(n))/alpha + lambda2)
    update: g = grad; sigma = (sqrt(n + g^2) - sqrt(n)) / alpha;
            z += g - sigma*w ; n += g^2.
    """

    def __init__(self, config: Configure, use_ps: bool = False,
                 device=None):
        self.config = config
        self.device = current_zoo().device if use_ps \
            else resolve_device(device)
        shape = _weight_shape(config)
        self._z = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._n = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._ftrl = ftrl_params(config)
        self._step = make_sparse_step(config, self._ftrl) if config.sparse \
            else make_dense_step(config)
        self._predict = make_predict(config, self._ftrl)
        self.update_count = 0
        # z and n that come in from outside the step (a load, a pull)
        # are settled to +0 by the next sparse step (z + (g - sigma*w)
        # and n + g*g add +0 there).
        self._settle = _settle_flag(config, self.device)
        self._use_ps = use_ps
        if use_ps:
            size = int(np.prod(shape))
            self._z_table = create_array_table(size)  # default adder
            self._n_table = create_array_table(size)
            self._batch_count = 0

    def update(self, batch: Batch) -> float:
        args = _args(batch, self.device)
        shape = tuple(self._z.shape)
        push = None
        if self.config.sparse:
            if self._use_ps:
                push = (torch.zeros(shape, dtype=torch.float32,
                                    device=self.device),
                        torch.zeros(shape, dtype=torch.float32,
                                    device=self.device))
            loss_sum = self._step((self._z, self._n), *args, push=push,
                                  settle=self._settle)[0]
        else:
            z, n = f(self._z), f(self._n)
            w = ftrl_weights(z, n, self._ftrl)
            loss_sum, _, g = self._step(w, *args)
            # As the reference's fused program forms it (ROADMAP C14):
            # ``n + g * g`` fused, ``/ alpha`` a product by ``1/alpha``,
            # ``sigma * w`` rounded before ``g - sigma * w``.
            n_new = fma(g, g, n)
            sigma_w = f(f(f(sqrt(n_new) - sqrt(n)) * _lr(
                self._ftrl.inv_alpha, g)) * w)
            push = (f(g - sigma_w), f(g * g))
            self._z, self._n = f(z + push[0]), n_new
        if self._use_ps:
            # Push the FTRL gradient pair {delta_z, delta_n}
            # (ref: util/data_type.h:13-54).
            self._z_table.add_async(push[0].reshape(-1))
            self._n_table.add_async(push[1].reshape(-1))
            self._batch_count += 1
            if self._batch_count % self.config.sync_frequency == 0:
                self._z = self._z_table.get_device().reshape(shape)
                self._n = self._n_table.get_device().reshape(shape)
                if self._settle is not None:
                    self._settle.request()
        self.update_count += 1
        return float(loss_sum)

    def predict(self, batch: Batch) -> np.ndarray:
        args = _args(batch, self.device)
        if self.config.sparse:
            pred = self._predict((self._z, self._n), *args[:-2])
        else:
            pred = self._predict(ftrl_weights(self._z, self._n, self._ftrl),
                                 *args[:-2])
        return pred.cpu().numpy()

    @property
    def weights(self) -> np.ndarray:
        return ftrl_weights(self._z, self._n, self._ftrl).cpu().numpy()

    def load_state(self, z: np.ndarray, n: np.ndarray) -> None:
        shape = tuple(self._z.shape)
        self._z = torch.from_numpy(np.array(z, np.float32).reshape(
            shape)).to(self.device)
        self._n = torch.from_numpy(np.array(n, np.float32).reshape(
            shape)).to(self.device)
        if self._settle is not None:
            self._settle.request()

    def store(self, stream) -> None:
        stream.write(self._z.cpu().numpy().tobytes())
        stream.write(self._n.cpu().numpy().tobytes())

    def load(self, stream) -> None:
        shape = _weight_shape(self.config)
        z = _read_rows(stream, shape)
        self.load_state(z, _read_rows(stream, shape))


def create_model(config: Configure, device=None):
    """Factory (ref: model.cpp Model::Get / main.cpp flow). ``device`` is
    the local models' (``cuda:0`` by default); the PS models use the
    zoo's."""
    if config.objective_type == "ftrl" or config.updater_type == "ftrl":
        return FTRLModel(config, use_ps=config.use_ps, device=device)
    if config.use_ps:
        return PSModel(config)
    return LocalModel(config, device=device)
