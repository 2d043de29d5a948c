"""K1: fused masked self-attention (``csrc/attention.cu``).

Replaces the attention core of ``SelfAttention.__call__``,
``pathway_tpu/models/encoder.py:113-117``.  Layout is the JAX one:
q, k, v and the output are ``[B, L, heads, head_dim]``; ``mask`` is
``[B, L]`` with 1 where a key is present.  Padded keys get a -1e30 bias.

:func:`attention` launches the CUDA kernel for CUDA tensors (bf16 or f32
q/k/v, uint8 mask, a head_dim that is a multiple of 8 up to 128, L up to
:data:`MAX_LEN`) and raises on anything else (:func:`check_attention` says
what it takes); for CPU tensors it runs :func:`attention_plain`.  The
kernel is built for head dims 16, 32, 64 and 128 (:data:`HEAD_DIMS`);
another multiple of 8 runs in the next one up, zero-padded inside the
tiles.  It walks only the key tiles of a batch row that hold a present
key (all of them for a row with none; :func:`walked_key_tiles` counts
them on the host).  In bf16 both products run on wgmma with K/V tiles
brought by TMA; in f32 as 3xTF32 on the tensor cores, which keeps the JAX
program's f32 accuracy.  ``with_lse=True`` also returns each row's
log-sum-exp ``[B, heads, L]`` f32, which the attention backward (K15,
:mod:`~pathway_tpu_torch.kernels.attention_bwd`) reads.
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = [
    "attention", "attention_plain", "check_attention", "check_head_dim",
    "walked_key_tiles", "MAX_LEN", "BIAS_LEN", "HEAD_DIMS", "MAX_HEAD_DIM", "DTYPES", "KEY_TILE",
    "attention_bwd", "attention_bwd_plain", "AttentionFunction",
]

#: the longest sequence the kernel takes (its walk keeps 10 bytes of shared
#: memory per 64-key tile; K14's limit too)
MAX_LEN = 1 << 19
#: up to this length the kernel keeps every key's bias in a shared array;
#: above, each tile's bias is made from its mask words
BIAS_LEN = 512
#: keys per tile of the kernel's walk (and query rows per block)
KEY_TILE = 64
#: the head dims the kernel is built for; another multiple of 8 up to the
#: last runs in the next one up, its padding columns zero in the tiles
HEAD_DIMS = (16, 32, 64, 128)
MAX_HEAD_DIM = HEAD_DIMS[-1]
#: the activation types the kernel takes
DTYPES = (torch.bfloat16, torch.float32)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, with_lse: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The JAX program's arithmetic: the q.k^T einsum comes out in the
    input type (bf16 rounds it) before the f32 scale, bias and softmax;
    the probabilities are cast back to the input type for the p.v einsum.
    ``with_lse``: also the rows' log-sum-exp ``[B, H, L]`` f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("blhd,bmhd->bhlm", q, k).float() * scale
    bias = torch.where(mask.bool()[:, None, None, :], 0.0, -1e30)
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v)
    if with_lse:
        return out, torch.logsumexp(logits + bias, dim=-1)
    return out


def check_head_dim(name: str, D: int) -> None:
    """The kernels' head dims: a multiple of 8 up to :data:`MAX_HEAD_DIM`
    (TMA's 16-byte row strides in bf16; the padded tile in f32)."""
    if D % 8 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8 up to {MAX_HEAD_DIM} "
                         f"(the kernel runs it in one of {HEAD_DIMS}, zero-padded)")


def check_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, L, H, D = q.shape
    if mask.shape != (B, L):
        raise ValueError(f"attention: mask {tuple(mask.shape)} != {(B, L)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: the kernel takes bf16 or f32 q, k and v of one type, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if mask.dtype != torch.uint8:
        raise ValueError(f"attention: mask must be uint8, got {mask.dtype}")
    check_head_dim("attention", D)
    if not 0 < L <= MAX_LEN:
        raise ValueError(f"attention: sequence length {L} not in 1..{MAX_LEN}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k and v must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and L * H * D * 2 >= 2**40:
        # bf16 tiles come by TMA through a [B, L, H, D] tensor map; at these
        # head dims its strides are whole 16 bytes, and a batch row's must be
        # under 2^40 bytes
        raise ValueError(f"attention: a batch row of {L * H * D * 2} bytes does not fit a tensor map")


def walked_key_tiles(mask: torch.Tensor) -> torch.Tensor:
    """Key tiles the kernel walks for each batch row of ``mask [B, L]``:
    those that hold a present key, or every tile when the row has none
    (its output is then the uniform average of v, as the plain version's)."""
    B, L = mask.shape
    n_tiles = -(-L // KEY_TILE)
    padded = torch.zeros((B, n_tiles * KEY_TILE), dtype=torch.bool, device=mask.device)
    padded[:, :L] = mask.bool()
    present = padded.view(B, n_tiles, KEY_TILE).any(dim=2).sum(dim=1)
    return torch.where(present > 0, present, n_tiles)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, with_lse: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Masked attention ``[B, L, H, D]`` (and with ``with_lse`` the rows'
    log-sum-exp ``[B, H, L]`` f32); the kernel on a card, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, with_lse)
    device = check_cuda("attention", q=q, k=k, v=v, mask=mask)
    check_attention(q, k, v, mask)
    B, L, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=device) if with_lse else None
    if B > 0:
        launch(
            "attention", _build.library("attention").pw_attention, device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, L, H, D, 1.0 / math.sqrt(D), int(q.dtype == torch.float32),
        )
        attention.launches += 1
    return (out, lse) if with_lse else out


#: launches of the CUDA kernel in this process
attention.launches = 0


# ---------------------------------------------------------------------------
# K15: the backward (csrc/attention_bwd.cu), and K1's autograd Function


def attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, dout: torch.Tensor,
    mask: torch.Tensor, lse: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`attention_plain` in f32, as autograd's softmax
    transpose gives them: p = exp(s - lse) (1 / L on a batch row with no
    present key), dv = p^T dO, ds = p * (dO v^T - rowsum(dO * o)), dq = ds k
    / sqrt(D), dk = ds^T q / sqrt(D)."""
    B, L, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    s = s + torch.where(mask.bool()[:, None, None, :], 0.0, -1e30)
    present = mask.bool().any(dim=1)[:, None, None, None]
    p = torch.where(present, torch.exp(s - lse[..., None]), torch.full_like(s, 1.0 / L))
    dv = torch.einsum("bhlm,blhd->bmhd", p, dout)
    delta = (dout * o).sum(-1).transpose(1, 2)  # [B, H, L]
    ds = p * (torch.einsum("blhd,bmhd->bhlm", dout, v) - delta[..., None])
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q) * scale
    return dq, dk, dv


def attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, dout: torch.Tensor,
    mask: torch.Tensor, lse: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of K1's f32 attention from its output ``o``, the output's
    gradient ``dout`` and K1's ``lse``; the kernel on a card (two launches),
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, dout, mask, lse)
    device = check_cuda("attention_bwd", q=q, k=k, v=v, o=o, dout=dout, mask=mask, lse=lse)
    check_attention(q, k, v, mask)
    B, L, H, D = q.shape
    if q.dtype != torch.float32 or o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype \
            or dout.dtype != q.dtype or lse.shape != (B, H, L) or lse.dtype != torch.float32:
        raise ValueError(f"attention_bwd: f32 q, k, v, o, dout {tuple(q.shape)} and lse {(B, H, L)}, got "
                         f"{q.dtype} o {tuple(o.shape)} dout {tuple(dout.shape)} lse {tuple(lse.shape)}")
    if B > 65535 or H > 65535:
        raise ValueError(f"attention_bwd: B={B} H={H} outside the kernel's grid")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B, H, L), dtype=torch.float32, device=device)
    if B > 0:
        launch(
            "attention_bwd", _build.library("attention_bwd").pw_attention_bwd, device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), mask.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, L, H, D, 1.0 / math.sqrt(D),
        )
        attention_bwd.launches += 2
    return dq, dk, dv


#: launches of the CUDA kernels in this process (two a call: dq, then dk/dv)
attention_bwd.launches = 0


class AttentionFunction(torch.autograd.Function):
    """K1 forward, K15 backward.  The forward keeps q, k, v, the output,
    the mask and the rows' log-sum-exp (K1's ``lse`` output).  Training
    runs in f32: a bf16 call runs K1 and its backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        if q.dtype != torch.float32:
            ctx.trained = False
            return attention(q, k, v, mask)
        out, lse = attention(q, k, v, mask, with_lse=True)
        ctx.trained = True
        ctx.save_for_backward(q, k, v, out, mask, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        if not ctx.trained:
            raise NotImplementedError("attention: the backward kernels take f32; bf16 is not trained")
        q, k, v, out, mask, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout.contiguous(), mask, lse)
        return dq, dk, dv, None
