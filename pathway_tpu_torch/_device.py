"""Device selection and asynchronous device->host readback for the port.

Every entry point of :mod:`pathway_tpu_torch` takes ``device=`` and
defaults to ``"cuda"``.  A machine with no card raises: the port never
moves to the CPU on its own.  Callers that want the CPU (the tests) ask
for it with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "upload", "start_readback", "finish_readback"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``, a bare ``"cuda"`` given the current
    card's index (so that it equals the device of a tensor made there);
    raises when it names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pathway_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without waiting.  On a card the
    array is staged in pinned memory: a copy from pageable memory would
    first wait for the stream to drain, which stalls a pipeline."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def start_readback(*tensors: torch.Tensor):
    """Start copying ``tensors`` to host memory without waiting; returns a
    handle for :func:`finish_readback`.  On a card the copies land in
    pinned buffers on the current stream and an event marks their end, so
    the host can enqueue more work before it reads them."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.cpu() for t in tensors], None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    event = torch.cuda.Event()
    event.record()
    return hosts, event


def finish_readback(handle) -> list:
    """Wait for a :func:`start_readback` handle; numpy arrays, in order."""
    hosts, event = handle
    if event is not None:
        event.synchronize()
    return [h.numpy() for h in hosts]
