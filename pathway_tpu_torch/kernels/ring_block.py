"""K14: one step of ring attention with the flash state carried in and out
(``csrc/ring_block.cu``).

Replaces ``_ring_body``, ``pathway_tpu/ops/ring_attention.py:47-77``: the
step each device of the sequence axis runs once per K/V block that
reaches it.  Layouts are the JAX ones: q, k, v ``[B, L, H, D]`` (the
query block and the K/V block, one length), ``mask`` ``[B, L]`` (1 where a
key of the K/V block is present), and the state o ``[B, H, L, D]``, m and
l ``[B, H, L]``, all f32 (:func:`ring_state` makes the first one: m at
-1e30, l and o at 0).

:func:`ring_block` updates ``(o, m, l)`` in place; with ``finalize=True``
it runs the step and returns ``o / max(l, 1e-30)`` as ``[B, L, H, D]`` in
q's type, leaving the state as it was.  For CUDA tensors it launches the
kernel (bf16 or f32 q/k/v, uint8 mask, head_dim 16, 32 or 64, any L) and
raises on anything else (:func:`check_ring_block` says what it takes);
for CPU tensors it runs :func:`ring_block_plain`.
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.kernels.attention import DTYPES, HEAD_DIMS

__all__ = ["ring_block", "ring_block_plain", "check_ring_block", "ring_state", "NEG"]

#: the additive bias of a masked key, and the running max's start
NEG = -1e30


def ring_state(
    B: int, L: int, H: int, D: int, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state before the first step: o = 0, m = -1e30, l = 0 (f32)."""
    o = torch.zeros((B, H, L, D), dtype=torch.float32, device=device)
    m = torch.full((B, H, L), NEG, dtype=torch.float32, device=device)
    l = torch.zeros((B, H, L), dtype=torch.float32, device=device)
    return o, m, l


def ring_block_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, finalize: bool = False,
) -> torch.Tensor | None:
    """The JAX step's arithmetic: q.k^T in the input type, then f32 scale
    and the -1e30 bias; the running max, rescale and sum in f32; p stays
    f32 and v is cast to f32 for p.v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blhd,bmhd->bhlm", q, k).float() * scale
    s = s + torch.where(mask.bool()[:, None, None, :], 0.0, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhlm,bmhd->bhld", p, v.float())
    if finalize:
        out = o_new / torch.clamp(l_new, min=1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype).contiguous()
    o.copy_(o_new)
    m.copy_(m_new)
    l.copy_(l_new)
    return None


def check_ring_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_block: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, L, H, D = q.shape
    if mask.shape != (B, L) or mask.dtype != torch.uint8:
        raise ValueError(f"ring_block: mask {tuple(mask.shape)} {mask.dtype}, want uint8 {(B, L)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"ring_block: the kernel takes bf16 or f32 q, k and v of one type, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"ring_block: head_dim {D} not in {HEAD_DIMS}")
    if o.shape != (B, H, L, D) or m.shape != (B, H, L) or l.shape != (B, H, L):
        raise ValueError(f"ring_block: state o {tuple(o.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)} for q {tuple(q.shape)}")
    if {o.dtype, m.dtype, l.dtype} != {torch.float32}:
        raise ValueError("ring_block: the state must be f32")
    if L == 0 or B > 65535 or H > 65535:
        raise ValueError(f"ring_block: B={B} L={L} H={H} outside the kernel's grid")
    if any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("ring_block: q, k, v and o must be 16-byte aligned")


def ring_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, finalize: bool = False,
) -> torch.Tensor | None:
    """One ring step over the K/V block (k, v, mask) for the query block
    q; the kernel on a card, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return ring_block_plain(q, k, v, mask, o, m, l, finalize)
    device = check_cuda("ring_block", q=q, k=k, v=v, mask=mask, o=o, m=m, l=l)
    check_ring_block(q, k, v, mask, o, m, l)
    B, L, H, D = q.shape
    out = torch.empty_like(q) if finalize else None
    if B == 0:
        return out
    launch(
        "ring_block", _build.library("ring_block").pw_ring_block, device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), None if out is None else out.data_ptr(),
        B, L, H, D, 1.0 / math.sqrt(D), int(q.dtype == torch.float32), int(finalize),
    )
    ring_block.launches += 1
    return out


#: launches of the CUDA kernel in this process
ring_block.launches = 0
