"""K11: nearest IVF centroid per row (``csrc/ivf_assign.cu``).

Replaces ``_assign_ip`` (``pathway_tpu/parallel/ivf_knn.py:44-47``),
``argmax(x @ c.T, axis=1)``, and the Lloyd step's ``_kmeans.assign``
(``:62-66``), ``argmax(x @ c.T - 0.5 * sum(c * c, axis=1), axis=1)``.
:func:`ivf_assign` takes ``x [n, d]`` and ``c [nlist, d]`` f32 and returns
``[n]`` int32; ``half_norm`` selects the Lloyd step's score.  Ties go to
the lower centroid, as ``jnp.argmax`` and ``torch.argmax`` give them.

For CUDA tensors the wrapper launches the kernel (d divisible by 4,
16-byte aligned rows), which never writes the ``[n, nlist]`` scores to
device memory, and raises on anything else; for CPU tensors it runs
:func:`ivf_assign_plain`.  The kernel takes the product on the tensor
cores in three TF32 passes (f32 accuracy, ``csrc/tf32x3.cuh``); a call is
two launches, the centroids' split into TF32 parts (into scratch the
wrapper allocates) and the assignment.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["ivf_assign", "ivf_assign_plain"]


def ivf_assign_plain(x: torch.Tensor, c: torch.Tensor, half_norm: bool) -> torch.Tensor:
    scores = x @ c.T
    if half_norm:
        scores = scores - 0.5 * (c * c).sum(1)
    return torch.argmax(scores, dim=1).to(torch.int32)


def ivf_assign(x: torch.Tensor, c: torch.Tensor, half_norm: bool) -> torch.Tensor:
    """Index of each row's best centroid: ``x . c`` (minus ``0.5 ||c||^2``
    when ``half_norm``)."""
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1] or c.shape[0] == 0:
        raise ValueError(f"ivf_assign: x {tuple(x.shape)}, c {tuple(c.shape)}")
    if x.device.type == "cpu":
        return ivf_assign_plain(x, c, half_norm)
    device = check_cuda("ivf_assign", x=x, c=c)
    n, d = x.shape
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise ValueError(f"ivf_assign: the kernel takes f32 rows and centroids, got {x.dtype}, {c.dtype}")
    if d % 4 or x.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("ivf_assign: the kernel takes a width divisible by 4 and 16-byte aligned rows")
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
