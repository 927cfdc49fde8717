"""Device-dispatch ordering for the port (one zoo per process).

Port of ``multiverso_tpu/runtime/device_lock.py``. The reference needs a
process-wide lock (``guard``, ``TABLE_LOCK``, multi-zoo ``enable``) and
per-dispatch settling because XLA's CPU runtime can wedge when two
multi-device programs from different threads are in flight at once
(several virtual ranks in one process). The port's slice runs ONE zoo
per process on one card, and every thread — trainer, worker actor,
server actor — launches onto the same CUDA stream (the legacy default
stream: PyTorch's current stream is per thread and no thread here sets
another one), so launch order IS execution order. Nothing needs a lock,
and the guard of the reference is a no-op here, so it is not carried
over. What remains is ``settle``: a stream sync, used only where the
host reads what the device produced.

A side stream, if one is ever added, needs ``record_stream`` on every
tensor that crosses actors.
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
