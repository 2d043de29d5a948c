"""K18: the in-batch contrastive loss and its gradient
(``csrc/contrastive_loss.cu``).

Replaces ``loss_fn`` of the train step, ``__graft_entry__.py:117-124``,
between its two dense products: from ``raw = emb @ emb.T`` ``[B, B]``
(f32), ``x = raw * 20`` minus 1e9 on the diagonal (each row's own
embedding masked), the row log-softmax and the cross-entropy at each
row's pair partner ``i ^ 1``, averaged over the rows
(``optax.softmax_cross_entropy_with_integer_labels(...).mean()``), and
``G = (softmax(x) - onehot(i ^ 1)) * 20 / B``, the loss's gradient with
respect to ``raw``.  The products ``emb @ emb.T`` and ``(G + G^T) @ emb``
are dense and stay ``torch.matmul`` (autograd of the first gives the
second).

B must be even: the reference pairs rows (0, 1), (2, 3), ...; with odd B
its last row's partner is row B, past the batch.  :func:`contrastive_loss`
raises there.

:func:`contrastive_loss` returns ``(loss, G)``: the kernel (one launch)
for CUDA tensors, :func:`contrastive_loss_plain` for CPU tensors.
:func:`in_batch_loss` is the loss of an embedding batch, differentiable
(:class:`ContrastiveLossFunction`).  The same source holds K7's backward
(:func:`~pathway_tpu_torch.kernels.pool_normalize.pool_normalize_bwd`).
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = [
    "contrastive_loss", "contrastive_loss_plain", "in_batch_loss", "ContrastiveLossFunction",
    "SCALE", "SELF_MASK",
]

#: the logits' temperature, ``emb @ emb.T * 20``
SCALE = 20.0
#: subtracted from each row's own logit
SELF_MASK = 1e9


def _check(raw: torch.Tensor, types=(torch.float32,)) -> int:
    if raw.dim() != 2 or raw.shape[0] != raw.shape[1] or raw.dtype not in types:
        raise ValueError(f"contrastive_loss: raw logits must be f32 [B, B], got {raw.dtype} {tuple(raw.shape)}")
    B = raw.shape[0]
    if B < 2 or B % 2:
        raise ValueError(f"contrastive_loss: B={B} must be even (rows pair as (0, 1), (2, 3), ...)")
    return B


def contrastive_loss_plain(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch (f32, or f64 for a gradient check)."""
    B = _check(raw, (torch.float32, torch.float64))
    x = raw * SCALE - SELF_MASK * torch.eye(B, dtype=raw.dtype, device=raw.device)
    pos = torch.arange(B, device=raw.device) ^ 1
    lse = torch.logsumexp(x, dim=1)
    loss = (lse - x[torch.arange(B, device=raw.device), pos]).mean()
    onehot = torch.nn.functional.one_hot(pos, B).to(raw.dtype)
    grad = (torch.exp(x - lse[:, None]) - onehot) * (SCALE / B)
    return loss, grad


def contrastive_loss(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(loss [] f32, G [B, B] f32)`` from the raw logits ``emb @ emb.T``;
    the kernel on a card, the plain version for CPU tensors."""
    if raw.device.type == "cpu":
        return contrastive_loss_plain(raw)
    B = _check(raw)
    device = check_cuda("contrastive_loss", raw=raw)
    loss = torch.empty((), dtype=torch.float32, device=device)
    grad = torch.empty_like(raw)
    launch(
        "contrastive_loss", _build.library("contrastive_loss").pw_contrastive_loss, device,
        raw.data_ptr(), loss.data_ptr(), grad.data_ptr(), B, SCALE, SELF_MASK,
    )
    contrastive_loss.launches += 1
    return loss, grad


#: launches of the CUDA kernel in this process
contrastive_loss.launches = 0


class ContrastiveLossFunction(torch.autograd.Function):
    """K18: the loss of the raw logits; the backward scales the G that the
    forward's launch wrote by the loss's incoming gradient."""

    @staticmethod
    def forward(ctx, raw):
        loss, grad = contrastive_loss(raw)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g


def in_batch_loss(emb: torch.Tensor) -> torch.Tensor:
    """The contrastive loss of ``emb [B, H]`` f32 (adjacent rows are
    positive pairs), differentiable."""
    return ContrastiveLossFunction.apply(emb @ emb.T)
