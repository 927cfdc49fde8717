"""Shared checks for the kernel wrappers: what a CUDA launch accepts."""

from __future__ import annotations

import torch

#: Shared memory one block may use on the card (Hopper: 227 KB).
SMEM_LIMIT = 232448

_multiprocessors = {}


def multiprocessors(device: torch.device) -> int:
    """The card's streaming multiprocessors (cached per device)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _multiprocessors:
        _multiprocessors[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _multiprocessors[index]


_handoff = {}


def handoff(device: torch.device, spans: int):
    """(counters [2], flags [>= spans]) int32 of the CBOW span kernels'
    handoff on ``device`` (K5, K7; ``csrc/w2v_common.cuh`` ``Handoff``):
    zeroed once, and every launch leaves them zero again."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctr, flags = _handoff.get(device, (None, None))
    if ctr is None or flags.numel() < spans:
        ctr = torch.zeros(2, dtype=torch.int32, device=device)
        flags = torch.zeros(max(spans, 4096), dtype=torch.int32,
                            device=device)
        _handoff[device] = (ctr, flags)
    return ctr, flags


def align4(x: int) -> int:
    """``csrc/w2v_common.cuh`` ``align4``: floats up to a 16-byte
    boundary."""
    return -(-x // 4) * 4


def cbow_span_floats(S: int, W: int, D: int, warps: int = 8) -> int:
    """Floats of ``cbow_span`` (``csrc/w2v_common.cuh``), the shared
    memory K5 and K7 share: the band rows of S + 2W positions, S window
    means, the window gradients of 2W + S centers and their pair mask,
    S context counts and two slots a warp."""
    W2, DP = 2 * W, align4(D)
    pm = (S + W2) * DP + S * DP + (W2 + S) * DP
    cnt = align4(pm + (W2 + S) * W2)
    return align4(align4(cnt + S) + 2 * warps)


def round_up(x: int, m: int) -> int:
    """The least multiple of ``m`` at or above ``x``."""
    return -(-x // m) * m


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device (0 for the legacy default stream every thread of the port
    launches on)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: int = -1) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on
    ``device`` (and of ``ndim`` dimensions when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim >= 0 and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def is_plain(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CPU (the plain version runs); False
    for a CUDA tensor (the kernel runs). Any other device raises: there
    is no path that carries on in a plain version off the CPU."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")
