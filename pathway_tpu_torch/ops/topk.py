"""Masked top-k over score matrices (counterpart of
``pathway_tpu/ops/topk.py``)."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "masked_top_k"]

#: score given to masked slots; callers drop results <= NEG_INF / 2
NEG_INF = -3.0e38


def masked_top_k(
    scores: torch.Tensor, valid: torch.Tensor | None, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k column indices per row, ignoring columns where ``valid == 0``.

    scores [nq, n] (higher = better), valid [n] in {0,1} or None.
    Returns (values [nq, k] f32, indices [nq, k] int64); masked-out slots
    surface as values <= NEG_INF/2 so callers can drop them.  Ties come
    back in no promised order (``torch.topk``), where ``jax.lax.top_k``
    prefers the lower index.
    """
    s = scores.float()
    if valid is not None:
        s = torch.where(valid.bool()[None, :], s, torch.full_like(s, NEG_INF))
    return torch.topk(s, k, dim=-1)
