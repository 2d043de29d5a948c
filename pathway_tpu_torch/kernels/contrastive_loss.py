"""K18: the in-batch contrastive loss of an embedding batch and its
gradient (``csrc/contrastive_loss.cu``).

Replaces ``loss_fn`` of the train step, ``__graft_entry__.py:117-124``,
both dense products included: ``raw = emb @ emb.T`` ``[B, B]`` (f32),
``x = raw * 20`` minus 1e9 on the diagonal (each row's own embedding
masked), the row log-softmax and the cross-entropy at each row's pair
partner ``i ^ 1``, averaged over the rows
(``optax.softmax_cross_entropy_with_integer_labels(...).mean()``).  Its
gradient with respect to ``raw`` is ``G = (softmax(x) - onehot(i ^ 1)) *
20 / B``, and with respect to ``emb`` ``(G + G^T) @ emb``.

Two launches a step: :func:`contrastive_loss` (the forward) computes the
product, the loss, and keeps ``raw`` and each row's log-sum-exp ``lse``;
:func:`contrastive_loss_bwd` rebuilds ``G + G^T`` from them and writes
``d emb``, scaled by the loss's incoming gradient read from the card.
Both are deterministic.  :func:`in_batch_loss` is the loss of an
embedding batch, differentiable (:class:`ContrastiveLossFunction`).  For
CPU tensors the wrappers run :func:`contrastive_loss_fwd_plain` and
:func:`contrastive_loss_bwd_plain` (:func:`contrastive_loss_plain` is the
arithmetic on ``raw``); for CUDA tensors they launch the kernels (f32,
even B, any H) and raise on anything else, as :func:`check_contrastive_loss`
says on any device.

B must be even: the reference pairs rows (0, 1), (2, 3), ...; with odd B
its last row's partner is row B, past the batch.  The same source holds
K7's backward (:func:`~pathway_tpu_torch.kernels.pool_normalize.pool_normalize_bwd`).
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = [
    "contrastive_loss", "contrastive_loss_bwd", "contrastive_loss_plain", "contrastive_loss_fwd_plain",
    "contrastive_loss_bwd_plain", "check_contrastive_loss", "in_batch_loss", "ContrastiveLossFunction",
    "SCALE", "SELF_MASK",
]

#: the logits' temperature, ``emb @ emb.T * 20``
SCALE = 20.0
#: subtracted from each row's own logit
SELF_MASK = 1e9
#: rows of ``d emb`` a block of the backward takes (its grid's y extent is at most 65,535)
_BWD_TILE = 64


def _check(raw: torch.Tensor, types=(torch.float32,)) -> int:
    if raw.dim() != 2 or raw.shape[0] != raw.shape[1] or raw.dtype not in types:
        raise ValueError(f"contrastive_loss: raw logits must be f32 [B, B], got {raw.dtype} {tuple(raw.shape)}")
    B = raw.shape[0]
    if B < 2 or B % 2:
        raise ValueError(f"contrastive_loss: B={B} must be even (rows pair as (0, 1), (2, 3), ...)")
    return B


def check_contrastive_loss(emb: torch.Tensor, types=(torch.float32,)) -> int:
    """Raise ``ValueError`` unless the kernels take ``emb`` (``[B, H]`` f32,
    contiguous, B even); reads shapes, strides and types only, on any
    device.  Returns B."""
    if emb.dim() != 2 or emb.dtype not in types:
        raise ValueError(f"contrastive_loss: emb must be f32 [B, H], got {emb.dtype} {tuple(emb.shape)}")
    B, H = emb.shape
    if B < 2 or B % 2:
        raise ValueError(f"contrastive_loss: B={B} must be even (rows pair as (0, 1), (2, 3), ...)")
    if H < 1:
        raise ValueError("contrastive_loss: emb has no columns")
    if -(-B // _BWD_TILE) > 65535:
        raise ValueError(f"contrastive_loss: B={B} rows are too many for one launch")
    if not emb.is_contiguous():
        raise ValueError("contrastive_loss: emb must be contiguous")
    return B


def _logits(raw: torch.Tensor) -> torch.Tensor:
    """``raw * 20`` minus 1e9 on the diagonal, in the JAX program's order."""
    return raw * SCALE - SELF_MASK * torch.eye(raw.shape[0], dtype=raw.dtype, device=raw.device)


def _grad(x: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """``G = (softmax(x) - onehot(i ^ 1)) * 20 / B``, the loss's gradient
    with respect to ``raw``."""
    B = x.shape[0]
    onehot = torch.nn.functional.one_hot(torch.arange(B, device=x.device) ^ 1, B).to(x.dtype)
    return (torch.exp(x - lse[:, None]) - onehot) * (SCALE / B)


def contrastive_loss_plain(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(loss, G)`` from the raw logits ``emb @ emb.T`` in torch (f32, or
    f64 for a gradient check)."""
    B = _check(raw, (torch.float32, torch.float64))
    x = _logits(raw)
    rows = torch.arange(B, device=raw.device)
    lse = torch.logsumexp(x, dim=1)
    loss = (lse - x[rows, rows ^ 1]).mean()
    return loss, _grad(x, lse)


def contrastive_loss_fwd_plain(emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward launch's outputs in torch: ``(loss [], lse [B], raw [B, B])``."""
    check_contrastive_loss(emb, (torch.float32, torch.float64))
    raw = emb @ emb.T
    return contrastive_loss_plain(raw)[0], torch.logsumexp(_logits(raw), dim=1), raw


def contrastive_loss_bwd_plain(
    emb: torch.Tensor, raw: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """The backward launch's ``d emb = g (G + G^T) @ emb`` in torch, ``G``
    rebuilt from ``raw`` and ``lse`` as :func:`contrastive_loss_plain`
    writes it."""
    check_contrastive_loss(emb, (torch.float32, torch.float64))
    grad = _grad(_logits(raw), lse)
    return ((grad + grad.T) @ emb) * g


def contrastive_loss(emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss [] f32, lse [B] f32, raw [B, B] f32)`` of ``emb`` ``[B, H]``;
    one launch on a card, the plain version for CPU tensors."""
    if emb.device.type == "cpu":
        return contrastive_loss_fwd_plain(emb)
    device = check_cuda("contrastive_loss", emb=emb)
    B = check_contrastive_loss(emb)
    loss = torch.empty((), dtype=torch.float32, device=device)
    kept = torch.empty((B + B * B,), dtype=torch.float32, device=device)
    lse, raw = kept[:B], kept[B:].view(B, B)
    launch(
        "contrastive_loss", _build.library("contrastive_loss").pw_contrastive_loss, device,
        emb.data_ptr(), loss.data_ptr(), lse.data_ptr(), raw.data_ptr(), B, emb.shape[1], SCALE, SELF_MASK,
    )
    contrastive_loss.launches += 1
    return loss, lse, raw


#: launches of the forward kernel in this process
contrastive_loss.launches = 0


def contrastive_loss_bwd(
    emb: torch.Tensor, raw: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """``d emb`` ``[B, H]`` f32 from the forward's ``raw`` and ``lse`` and the
    loss's incoming gradient ``g`` (a one-value tensor, read on the card);
    one launch on a card, the plain version for CPU tensors."""
    if emb.device.type == "cpu":
        return contrastive_loss_bwd_plain(emb, raw, lse, g)
    device = check_cuda("contrastive_loss_bwd", emb=emb, raw=raw, lse=lse, g=g)
    B = check_contrastive_loss(emb)
    if (raw.shape != (B, B) or lse.shape != (B,) or g.numel() != 1
            or any(t.dtype != torch.float32 for t in (raw, lse, g))):
        raise ValueError(f"contrastive_loss_bwd: f32 raw [{B}, {B}], lse [{B}] and a one-value g, got "
                         f"{tuple(raw.shape)}, {tuple(lse.shape)}, {tuple(g.shape)}")
    demb = torch.empty_like(emb)
    launch(
        "contrastive_loss_bwd", _build.library("contrastive_loss").pw_contrastive_loss_bwd, device,
        emb.data_ptr(), raw.data_ptr(), lse.data_ptr(), g.data_ptr(), demb.data_ptr(), B, emb.shape[1],
        SCALE, SELF_MASK,
    )
    contrastive_loss_bwd.launches += 1
    return demb


#: launches of the backward kernel in this process
contrastive_loss_bwd.launches = 0


class ContrastiveLossFunction(torch.autograd.Function):
    """K18: the loss of an embedding batch (one launch); the backward is the
    second launch, from what the first kept (``raw``, ``lse``)."""

    @staticmethod
    def forward(ctx, emb):
        loss, lse, raw = contrastive_loss(emb)
        ctx.save_for_backward(emb, raw, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        emb, raw, lse = ctx.saved_tensors
        return contrastive_loss_bwd(emb, raw, lse, g.contiguous())


def in_batch_loss(emb: torch.Tensor) -> torch.Tensor:
    """The contrastive loss of ``emb [B, H]`` f32 (adjacent rows are
    positive pairs), differentiable."""
    return ContrastiveLossFunction.apply(emb)
