"""Shared checks of the kernel wrappers."""

from __future__ import annotations

import torch

__all__ = ["check_cuda", "launch"]


def check_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """All ``tensors`` on one CUDA device and contiguous; returns it."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {device}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return device


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, err: int) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C launch function ``fn(*args, stream)`` on ``device``'s
    current stream and raise on a CUDA error.  ``device`` is made the
    thread's current device for the call: each library carries its own
    CUDA runtime, which launches on the current device."""
    with torch.cuda.device(device):
        err = fn(*args, stream_of(device))
    raise_on_error(name, err)
