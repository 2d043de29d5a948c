"""K11: nearest IVF centroid per row (``csrc/ivf_assign.cu``).

Replaces ``_assign_ip`` (``pathway_tpu/parallel/ivf_knn.py:44-47``),
``argmax(x @ c.T, axis=1)``, and the Lloyd step's ``_kmeans.assign``
(``:62-66``), ``argmax(x @ c.T - 0.5 * sum(c * c, axis=1), axis=1)``.
:func:`ivf_assign` takes ``x [n, d]`` and ``c [nlist, d]`` f32 and returns
``[n]`` int32; ``half_norm`` selects the Lloyd step's score.  Ties go to
the lower centroid, as ``jnp.argmax`` and ``torch.argmax`` give them.

For CUDA tensors the wrapper launches the kernel (16-byte aligned rows
16 bytes apart: rows of another width are taken over their row pitch,
:mod:`~pathway_tpu_torch.kernels._pitch`, or copied with zero columns up
to a multiple of 4, which leaves every score as it is), which never
writes the ``[n, nlist]`` scores to device memory, and raises on anything
else; for CPU tensors it runs
:func:`ivf_assign_plain`.  The kernel takes the product on the tensor
cores in three TF32 passes (f32 accuracy, ``csrc/tf32x3.cuh``); a call is
two launches, the centroids' split into TF32 parts (into scratch the
wrapper allocates) and the assignment.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.kernels._pitch import widen

__all__ = ["ivf_assign", "ivf_assign_plain"]


def ivf_assign_plain(x: torch.Tensor, c: torch.Tensor, half_norm: bool) -> torch.Tensor:
    scores = x @ c.T
    if half_norm:
        scores = scores - 0.5 * (c * c).sum(1)
    return torch.argmax(scores, dim=1).to(torch.int32)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` over its whole row pitch when that is a multiple of 4, else a
    copy with zero columns up to one."""
    try:
        return widen(t, 4, "ivf_assign")
    except ValueError:
        d = t.shape[1]
        return torch.nn.functional.pad(t, (0, -d % 4))


def ivf_assign(x: torch.Tensor, c: torch.Tensor, half_norm: bool) -> torch.Tensor:
    """Index of each row's best centroid: ``x . c`` (minus ``0.5 ||c||^2``
    when ``half_norm``)."""
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1] or c.shape[0] == 0:
        raise ValueError(f"ivf_assign: x {tuple(x.shape)}, c {tuple(c.shape)}")
    if x.device.type == "cpu":
        return ivf_assign_plain(x, c, half_norm)
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise ValueError(f"ivf_assign: the kernel takes f32 rows and centroids, got {x.dtype}, {c.dtype}")
    x, c = _rows(x), _rows(c)
    device = check_cuda("ivf_assign", x=x, c=c)
    n, d = x.shape
    if x.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("ivf_assign: the kernel takes 16-byte aligned rows")
    nlist = c.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return out
    # the centroids' TF32 hi and lo parts, then 0.5 ||c||^2
    scratch = torch.empty((2 * nlist * d + nlist,), dtype=torch.float32, device=device)
    launch(
        "ivf_assign", _build.library("ivf_assign").pw_ivf_assign, device,
        x.data_ptr(), c.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, d, nlist, int(bool(half_norm)),
    )
    ivf_assign.launches += 2
    return out


#: launches of the CUDA kernels in this process (two a call)
ivf_assign.launches = 0
