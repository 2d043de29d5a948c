"""K2: fused normalise + cast + scatter into the KNN slab, and the clear
of valid flags (``csrc/slab_scatter.cu``).

Replaces ``_scatter_set_device`` / ``_scatter_set`` / ``_scatter_clear``
(and the ``_safe`` twins), ``pathway_tpu/parallel/sharded_knn.py:123-176``.
Both functions update ``slab`` and ``valid`` in place; slots outside
``[0, capacity)`` are dropped, as ``mode="drop"`` drops them.  The
optional normalise divides by ``max(||row||, 1e-30)`` in f32: that is the
ingest epsilon of the JAX package, not the 1e-12 of ``ops.normalize``.

``slab`` may be a view of rows a pitch apart (``[capacity, d]`` of
``[capacity, pitch]`` storage, :mod:`~pathway_tpu_torch.kernels._pitch`):
the kernel writes the d columns of a row and leaves the rest.  For CUDA
tensors the wrappers launch the kernels (any d) and raise on what they do
not take; for CPU tensors they run the plain versions.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["slab_scatter", "slab_scatter_plain", "slab_clear", "slab_clear_plain"]

INGEST_EPS = 1e-30
_TYPES = (torch.float32, torch.bfloat16)


def _kept(slots: torch.Tensor, capacity: int) -> torch.Tensor:
    return (slots >= 0) & (slots < capacity)


def slab_scatter_plain(
    slab: torch.Tensor, valid: torch.Tensor, slots: torch.Tensor,
    vals: torch.Tensor, normalize: bool,
) -> None:
    rows = vals.float()
    if normalize:
        norm = torch.linalg.vector_norm(rows, dim=1, keepdim=True)
        rows = rows / torch.clamp(norm, min=INGEST_EPS)
    keep = _kept(slots, slab.shape[0])
    idx = slots[keep].long()
    slab[idx] = rows[keep].to(slab.dtype)
    valid[idx] = 1.0


def slab_clear_plain(valid: torch.Tensor, slots: torch.Tensor) -> None:
    valid[slots[_kept(slots, valid.shape[0])].long()] = 0.0


def slab_scatter(
    slab: torch.Tensor, valid: torch.Tensor, slots: torch.Tensor,
    vals: torch.Tensor, normalize: bool,
) -> None:
    """``slab[slots[i]] = cast(normalize?(vals[i]))``, ``valid[slots[i]] = 1``."""
    if slab.device.type == "cpu":
        return slab_scatter_plain(slab, valid, slots, vals, normalize)
    cap, d = slab.shape
    if slab.dim() != 2 or slab.stride(1) != 1 or slab.stride(0) < d:
        raise ValueError(f"slab_scatter: slab {tuple(slab.shape)} strides {slab.stride()}: rows of a pitch >= d")
    pitch = slab.stride(0)
    wide = torch.as_strided(slab, (cap, pitch), (pitch, 1))
    device = check_cuda("slab_scatter", slab=wide, valid=valid, slots=slots, vals=vals)
    n = slots.shape[0]
    if slab.dtype not in _TYPES or vals.dtype not in _TYPES:
        raise ValueError(f"slab_scatter: slab {slab.dtype} / vals {vals.dtype} not f32 or bf16")
    if valid.dtype != torch.float32 or valid.shape != (cap,):
        raise ValueError("slab_scatter: valid must be f32 [capacity]")
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise ValueError("slab_scatter: slots must be int32 [n]")
    if vals.shape != (n, d):
        raise ValueError(f"slab_scatter: vals {tuple(vals.shape)} != {(n, d)}")
    if n == 0:
        return
    launch(
        "slab_scatter", _build.library("slab_scatter").pw_slab_scatter, device,
        slab.data_ptr(), valid.data_ptr(), slots.data_ptr(), vals.data_ptr(),
        n, d, pitch, cap, int(slab.dtype == torch.bfloat16), int(vals.dtype == torch.bfloat16),
        int(bool(normalize)),
    )
    slab_scatter.launches += 1


def slab_clear(valid: torch.Tensor, slots: torch.Tensor) -> None:
    """``valid[slots[i]] = 0`` for every in-range slot."""
    if valid.device.type == "cpu":
        return slab_clear_plain(valid, slots)
    device = check_cuda("slab_clear", valid=valid, slots=slots)
    if valid.dtype != torch.float32 or valid.dim() != 1:
        raise ValueError("slab_clear: valid must be f32 [capacity]")
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise ValueError("slab_clear: slots must be int32 [n]")
    if slots.shape[0] == 0:
        return
    launch(
        "slab_clear", _build.library("slab_scatter").pw_slab_clear, device,
        valid.data_ptr(), slots.data_ptr(), slots.shape[0], valid.shape[0],
    )
    slab_clear.launches += 1


#: launches of the CUDA kernels in this process
slab_scatter.launches = 0
slab_clear.launches = 0
