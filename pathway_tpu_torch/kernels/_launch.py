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


#: PyTorch's getters of the current device and of a device's current
#: stream handle (the value of ``torch.cuda.current_stream(device).cuda_stream``),
#: read without building a ``torch.cuda.Stream``; None where the installed
#: PyTorch has no CUDA, and then no kernel launches (``check_cuda`` raises)
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return _raw_stream(device.index)


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C launch function ``fn(*args, stream)`` on ``device``'s
    current stream and raise on a CUDA error.  Each library carries its own
    CUDA runtime, which launches on the thread's current device: ``device``
    (a CUDA device with its index, as a tensor's) is made current for the
    call where it is not already."""
    index = device.index
    if index == _current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
