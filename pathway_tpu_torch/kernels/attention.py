"""K1: fused masked self-attention (``csrc/attention.cu``).

Replaces the attention core of ``SelfAttention.__call__``,
``pathway_tpu/models/encoder.py:113-117``.  Layout is the JAX one:
q, k, v and the output are ``[B, L, heads, head_dim]``; ``mask`` is
``[B, L]`` with 1 where a key is present.  Padded keys get a -1e30 bias.

:func:`attention` launches the CUDA kernel for CUDA tensors (bf16 or f32
q/k/v, uint8 mask, head_dim 16, 32 or 64, L <= 512) and raises on
anything else (:func:`check_attention` says what it takes); for CPU
tensors it runs :func:`attention_plain`.  The kernel walks only the key
tiles of a batch row that hold a present key (all of them for a row with
none; :func:`walked_key_tiles` counts them on the host).  In bf16 both
products run on wgmma with K/V tiles brought by TMA; in f32 as 3xTF32 on
the tensor cores, which keeps the JAX program's f32 accuracy.
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = [
    "attention", "attention_plain", "check_attention", "walked_key_tiles",
    "MAX_LEN", "HEAD_DIMS", "DTYPES", "KEY_TILE",
]

MAX_LEN = 512
#: keys per tile of the kernel's walk (and query rows per block)
KEY_TILE = 64
HEAD_DIMS = (16, 32, 64)
#: the activation types the kernel takes
DTYPES = (torch.bfloat16, torch.float32)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The JAX program's arithmetic: the q.k^T einsum comes out in the
    input type (bf16 rounds it) before the f32 scale, bias and softmax;
    the probabilities are cast back to the input type for the p.v einsum."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("blhd,bmhd->bhlm", q, k).float() * scale
    bias = torch.where(mask.bool()[:, None, None, :], 0.0, -1e30)
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


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
    if D not in HEAD_DIMS:
        raise ValueError(f"attention: head_dim {D} not in {HEAD_DIMS}")
    if not 0 < L <= MAX_LEN:
        raise ValueError(f"attention: sequence length {L} not in 1..{MAX_LEN}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k and v must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and L * H * D * 2 >= 2**40:
        # bf16 tiles come by TMA through a [B, L, H, D] tensor map; at these
        # head dims its strides are whole 32 bytes, and a batch row's must be
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked attention ``[B, L, H, D]``; the kernel on a card, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    device = check_cuda("attention", q=q, k=k, v=v, mask=mask)
    check_attention(q, k, v, mask)
    B, L, H, D = q.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    launch(
        "attention", _build.library("attention").pw_attention, device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, L, H, D, 1.0 / math.sqrt(D), int(q.dtype == torch.float32),
    )
    attention.launches += 1
    return out


#: launches of the CUDA kernel in this process
attention.launches = 0
