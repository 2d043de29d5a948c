"""K7: the sentence encoder's tail, pooling + optional L2 normalise
(``csrc/pool_normalize.cu``).

Replaces the tail of ``TextEncoderModel.__call__``,
``pathway_tpu/models/encoder.py:196-202``, with ``masked_mean_pool`` /
``cls_pool`` (``pathway_tpu/ops/pooling.py:11-21``): the pooled row in the
hidden type (a masked mean is taken in f32 and rounded back), then, when
``normalize`` is set, ``p / max(||p||, 1e-12)`` in f32.

:func:`pool_normalize` returns ``[B, H]`` f32.  For CUDA tensors it
launches the kernel (bf16 or f32 ``x``, uint8 ``mask``, even H up to
2048) and raises on anything else (:func:`check_pool_normalize` says what
it takes); for CPU tensors it runs :func:`pool_normalize_plain`.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.ops.pooling import cls_pool, masked_mean_pool

__all__ = [
    "pool_normalize", "pool_normalize_plain", "check_pool_normalize", "POOLS", "NORM_EPS",
    "pool_normalize_bwd", "pool_normalize_bwd_plain", "PoolNormalizeFunction",
]

POOLS = ("mean", "cls")
#: the hidden types the kernel takes
DTYPES = (torch.bfloat16, torch.float32)
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


def check_pool_normalize(x: torch.Tensor, mask: torch.Tensor, pool: str) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes and types only, on any device."""
    if pool not in POOLS:
        raise ValueError(f"pool_normalize: pool {pool!r} not in {POOLS}")
    if x.dim() != 3 or mask.shape != x.shape[:2]:
        raise ValueError(f"pool_normalize: x {tuple(x.shape)}, mask {tuple(mask.shape)}")
    L, h = x.shape[1:]
    if x.dtype not in DTYPES or mask.dtype != torch.uint8:
        raise ValueError(f"pool_normalize: the kernel takes bf16 or f32 x and uint8 mask, "
                         f"got {x.dtype}, {mask.dtype}")
    if h % 2 or not 0 < h <= MAX_HIDDEN or L == 0:
        raise ValueError(f"pool_normalize: hidden {h} must be even and at most {MAX_HIDDEN}, L > 0")


def pool_normalize(
    x: torch.Tensor, mask: torch.Tensor, pool: str = "mean", normalize: bool = True
) -> torch.Tensor:
    """Pooled (and normalised) f32 ``[B, H]`` from ``x`` ``[B, L, H]``; the
    kernel on a card, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return pool_normalize_plain(x, mask, pool, normalize)
    device = check_cuda("pool_normalize", x=x, mask=mask)
    check_pool_normalize(x, mask, pool)
    B, L, h = x.shape
    out = torch.empty((B, h), dtype=torch.float32, device=device)
    if B == 0:
        return out
    launch(
        "pool_normalize", _build.library("pool_normalize").pw_pool_normalize, device,
        x.data_ptr(), mask.data_ptr(), out.data_ptr(), B, L, h,
        int(pool == "cls"), int(bool(normalize)), int(x.dtype == torch.float32),
    )
    pool_normalize.launches += 1
    return out


#: launches of the CUDA kernel in this process
pool_normalize.launches = 0


# ---------------------------------------------------------------------------
# K7's backward (the second kernel of csrc/contrastive_loss.cu), and its
# autograd Function


def pool_normalize_bwd_plain(
    x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor, pool: str, normalize: bool
) -> torch.Tensor:
    """d hidden ``[B, L, H]`` from ``g``, the gradient of
    :func:`pool_normalize_plain`'s f32 output: the normalise's backward
    ((g - e (e . g)) / ||p||, or g / 1e-12 below it), then the pooling's."""
    p = (cls_pool(x) if pool == "cls" else masked_mean_pool(x, mask)).float()
    dp = g
    if normalize:
        norm = torch.sqrt(torch.sum(p**2, dim=-1, keepdim=True))
        den = torch.clamp(norm, min=NORM_EPS)
        e = p / den
        dp = torch.where(norm > NORM_EPS, (g - e * (e * g).sum(-1, keepdim=True)) / den, g / NORM_EPS)
    if pool == "cls":
        dh = torch.zeros_like(x, dtype=torch.float32)
        dh[:, 0] = dp
        return dh
    m = mask.float()[..., None]
    return dp[:, None, :] * m / torch.clamp(m.sum(1, keepdim=True), min=1.0)


def pool_normalize_bwd(
    x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor, pool: str, normalize: bool
) -> torch.Tensor:
    """K7's backward for f32 ``x``; the kernel on a card (one launch), the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return pool_normalize_bwd_plain(x, mask, g, pool, normalize)
    device = check_cuda("pool_normalize_bwd", x=x, mask=mask, g=g)
    check_pool_normalize(x, mask, pool)
    B, L, h = x.shape
    if x.dtype != torch.float32 or g.dtype != torch.float32 or g.shape != (B, h):
        raise ValueError(f"pool_normalize_bwd: f32 x {tuple(x.shape)} and g {(B, h)}")
    dh = torch.empty((B, L, h), dtype=torch.float32, device=device)
    if B > 0:
        launch(
            "pool_normalize_bwd", _build.library("contrastive_loss").pw_pool_normalize_bwd, device,
            x.data_ptr(), mask.data_ptr(), g.data_ptr(), dh.data_ptr(), B, L, h,
            int(pool == "cls"), int(bool(normalize)), NORM_EPS,
        )
        pool_normalize_bwd.launches += 1
    return dh


#: launches of the CUDA kernel in this process
pool_normalize_bwd.launches = 0


class PoolNormalizeFunction(torch.autograd.Function):
    """K7 forward, K18's pool backward.  The forward keeps the hidden rows
    and the mask (the backward pools again).  Training runs in f32: a bf16
    call runs K7 and its backward raises."""

    @staticmethod
    def forward(ctx, x, mask, pool, normalize):
        ctx.pool, ctx.normalize = pool, normalize
        ctx.trained = x.dtype == torch.float32
        if ctx.trained:
            ctx.save_for_backward(x, mask)
        return pool_normalize(x, mask, pool, normalize)

    @staticmethod
    def backward(ctx, g):
        if not ctx.trained:
            raise NotImplementedError("pool_normalize: the backward kernels take f32; bf16 is not trained")
        x, mask = ctx.saved_tensors
        return pool_normalize_bwd(x, mask, g.contiguous(), ctx.pool, ctx.normalize), None, None, None
