"""Device-dispatch ordering for the port: one stream, no lock.

Port of ``multiverso_tpu/runtime/device_lock.py``. The reference needs a
process-wide lock (``guard``, ``TABLE_LOCK``, multi-zoo ``enable``) and
per-dispatch settling because XLA's CPU runtime can wedge when two
multi-device programs from different threads are in flight at once
(several virtual ranks in one process).

The port has no such wedge, with one zoo or several. A process may run
one zoo, or several virtual ranks of a ``LocalCluster``
(``runtime/cluster.py``), each with its own zoo, actors and tables on
the same card. Every thread of every zoo — the trainers, the worker and
server actors, the rank threads — launches onto the same CUDA stream
(the legacy default stream: PyTorch's current stream is per thread and
no thread here sets another one). Launch order is execution order, so a
server's gather runs after the scatter a sibling rank launched before it,
and no kernel of one rank overlaps another's. Nothing needs a lock, and
the reference's guard is not carried over. Kernel launches from several
threads interleave, but each launch is one call into the CUDA runtime,
which serializes them. What remains is ``settle``: a stream sync, used only
where the host reads what the device produced.

A side stream, if one is ever added, needs ``record_stream`` on every
tensor that crosses actors or ranks.
"""

from __future__ import annotations


def settle(x):
    """Block until the stream that produced the CUDA tensor ``x`` has
    finished (identity for CPU tensors and anything else). Only for
    sites where a host read follows."""
    import torch
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return x
