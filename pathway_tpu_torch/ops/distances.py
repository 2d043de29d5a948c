"""Distance/similarity functions over row-major embedding matrices.

Counterpart of ``pathway_tpu/ops/distances.py``: one ``[nq, d] @ [d, n]``
product computes every query-corpus pair at once, accumulated in f32.
These are the plain building blocks of the retrieval kernel
(``kernels/knn_topk.py``) and the CPU path.
"""

from __future__ import annotations

import torch

__all__ = ["normalize", "dot_scores", "cosine_scores", "l2sq_distances"]


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize rows (f32 accumulation even for bf16 inputs)."""
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps).to(x.dtype)).to(x.dtype)


def dot_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """``[nq, d] x [n, d] -> [nq, n]`` inner-product scores (higher=closer),
    accumulated and returned in f32."""
    return torch.matmul(queries.float(), corpus.float().T)


def cosine_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Cosine similarity, normalizing both sides."""
    return dot_scores(normalize(queries), normalize(corpus))


def l2sq_distances(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance via the ||q||^2 - 2qc + ||c||^2 expansion,
    clamped at 0 (lower=closer)."""
    q32 = queries.float()
    c32 = corpus.float()
    qq = torch.sum(q32 * q32, dim=-1, keepdim=True)  # [nq, 1]
    cc = torch.sum(c32 * c32, dim=-1)  # [n]
    qc = dot_scores(queries, corpus)  # [nq, n]
    return torch.clamp(qq - 2.0 * qc + cc[None, :], min=0.0)
