"""Mask-aware sequence pooling for sentence encoders
(counterpart of ``pathway_tpu/ops/pooling.py``)."""

from __future__ import annotations

import torch

__all__ = ["masked_mean_pool", "cls_pool"]


def masked_mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid positions. hidden [B, L, H], mask [B, L] {0,1}."""
    m = mask.float()[..., None]
    summed = torch.sum(hidden.float() * m, dim=1)
    counts = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return (summed / counts).to(hidden.dtype)


def cls_pool(hidden: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """First-token ([CLS]) pooling."""
    return hidden[:, 0, :]
