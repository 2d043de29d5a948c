"""K7: the sentence encoder's tail, pooling + optional L2 normalise
(``csrc/pool_normalize.cu``).

Replaces the tail of ``TextEncoderModel.__call__``,
``pathway_tpu/models/encoder.py:196-202``, with ``masked_mean_pool`` /
``cls_pool`` (``pathway_tpu/ops/pooling.py:11-21``): the pooled row in the
hidden type (a masked mean is taken in f32 and rounded back), then, when
``normalize`` is set, ``p / max(||p||, 1e-12)`` in f32.

:func:`pool_normalize` returns ``[B, H]`` f32.  For CUDA tensors it
launches the kernel (bf16 ``x``, uint8 ``mask``, even H up to 2048) and
raises on anything else; for CPU tensors it runs :func:`pool_normalize_plain`.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.ops.pooling import cls_pool, masked_mean_pool

__all__ = ["pool_normalize", "pool_normalize_plain", "POOLS", "NORM_EPS"]

POOLS = ("mean", "cls")
NORM_EPS = 1e-12
MAX_HIDDEN = 2048


def pool_normalize_plain(
    x: torch.Tensor, mask: torch.Tensor, pool: str, normalize: bool
) -> torch.Tensor:
    if pool not in POOLS:
        raise ValueError(f"pool_normalize: pool {pool!r} not in {POOLS}")
    pooled = (cls_pool(x) if pool == "cls" else masked_mean_pool(x, mask)).float()
    if normalize:
        norm = torch.sqrt(torch.sum(pooled**2, dim=-1, keepdim=True))
        pooled = pooled / torch.clamp(norm, min=NORM_EPS)
    return pooled


def pool_normalize(
    x: torch.Tensor, mask: torch.Tensor, pool: str = "mean", normalize: bool = True
) -> torch.Tensor:
    """Pooled (and normalised) f32 ``[B, H]`` from ``x`` ``[B, L, H]``; the
    kernel on a card, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return pool_normalize_plain(x, mask, pool, normalize)
    device = check_cuda("pool_normalize", x=x, mask=mask)
    if pool not in POOLS:
        raise ValueError(f"pool_normalize: pool {pool!r} not in {POOLS}")
    if x.dim() != 3 or mask.shape != x.shape[:2]:
        raise ValueError(f"pool_normalize: x {tuple(x.shape)}, mask {tuple(mask.shape)}")
    B, L, h = x.shape
    if x.dtype != torch.bfloat16 or mask.dtype != torch.uint8:
        raise ValueError(f"pool_normalize: the kernel takes bf16 x and uint8 mask, got {x.dtype}, {mask.dtype}")
    if h % 2 or not 0 < h <= MAX_HIDDEN or L == 0:
        raise ValueError(f"pool_normalize: hidden {h} must be even and at most {MAX_HIDDEN}, L > 0")
    out = torch.empty((B, h), dtype=torch.float32, device=device)
    if B == 0:
        return out
    launch(
        "pool_normalize", _build.library("pool_normalize").pw_pool_normalize, device,
        x.data_ptr(), mask.data_ptr(), out.data_ptr(), B, L, h,
        int(pool == "cls"), int(bool(normalize)),
    )
    pool_normalize.launches += 1
    return out


#: launches of the CUDA kernel in this process
pool_normalize.launches = 0
