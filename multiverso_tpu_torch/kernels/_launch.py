"""Shared checks for the kernel wrappers: what a CUDA launch accepts."""

from __future__ import annotations

import torch


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
