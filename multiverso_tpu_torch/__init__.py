"""multiverso_tpu_torch: the PyTorch/CUDA port of multiverso_tpu.

A second package beside the JAX reference (``multiverso_tpu``), holding
the same parameter-server design on PyTorch: table state lives in
``torch.Tensor`` storage on a CUDA card, the actor runtime is the
reference's, and the row data plane and the word2vec step run on
hand-written Hopper kernels (``kernels/``, sources in ``csrc/``). This
package imports torch and numpy, never JAX and nothing of the reference.

Public API mirrors the reference's ``MV_*`` surface
(ref: include/multiverso/multiverso.h:9-65) for the slice ported so far.
"""

from __future__ import annotations

from typing import List, Optional

from .runtime.cluster import LocalCluster  # noqa: F401
from .runtime.zoo import (ClusterAborted, Zoo, current_zoo,  # noqa: F401
                          set_default_zoo, set_thread_zoo)
from .tables import (ArrayTableOption, KVTableOption,  # noqa: F401
                     MatrixTableOption, create_array_table,
                     create_kv_table, create_matrix_table, create_table)
from .tables.table_interface import TableRequestError  # noqa: F401
from .updater import AddOption, GetOption  # noqa: F401
from .util.configure import set_flag as _set_flag

__version__ = "0.1.0"


def init(argv: Optional[List[str]] = None, device=None) -> List[str]:
    """MV_Init (ref: src/multiverso.cpp:11-14). Returns remaining argv.
    Tables live on ``device``: ``cuda:0`` by default, which raises when
    no CUDA card is present (there is no CPU fallback); pass
    ``device="cpu"`` to run on the CPU."""
    zoo = Zoo()
    remaining = zoo.start(argv, device=device)
    set_default_zoo(zoo)
    return remaining


def shutdown(finalize_net: bool = True) -> None:
    """MV_ShutDown (ref: src/multiverso.cpp:20-23)."""
    from .runtime import zoo as zoo_mod
    zoo = current_zoo()
    zoo.stop(finalize_net)
    if getattr(zoo_mod._tls, "zoo", None) is zoo:
        set_thread_zoo(None)
    if zoo_mod._default_zoo is zoo:
        set_default_zoo(None)


def barrier() -> None:
    """MV_Barrier (ref: src/multiverso.cpp:16-18)."""
    current_zoo().barrier()


def rank() -> int:
    return current_zoo().rank


def size() -> int:
    return current_zoo().size


def num_workers() -> int:
    return current_zoo().num_workers


def num_servers() -> int:
    return current_zoo().num_servers


def worker_id() -> int:
    return current_zoo().worker_id


def server_id() -> int:
    return current_zoo().server_id


def set_flag(name: str, value) -> None:
    """MV_SetFlag (ref: src/multiverso.cpp:48-51)."""
    _set_flag(name, value)
