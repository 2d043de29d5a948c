"""K9: the vision tower's tail, f32 mean + f32 projection + L2 normalise
(``csrc/vision_head.cu``).

Replaces the tail of ``VisionEncoderModel.__call__``,
``pathway_tpu/models/vision.py:81-87``: ``jnp.mean(x.astype(f32), axis=1)``
over every patch row, kept in f32 (the text tail, K7, rounds its mean
back to the hidden type; this one does not), the f32 ``projection``
Dense, then ``out / max(||out||, 1e-12)``.

:func:`vision_head` returns ``[B, embed_dim]`` f32 from ``x``
``[B, P, hidden]`` and the projection as a torch ``Linear`` holds it
(``weight`` ``[embed_dim, hidden]``, ``bias`` ``[embed_dim]``, f32).  For
CUDA tensors it launches the kernel (bf16 or f32 ``x``, hidden divisible by
4 and at most 2048, hidden + embed_dim at most 11,264) and raises on
anything else, as :func:`check_vision_head` says on any device; for CPU
tensors it runs :func:`vision_head_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["vision_head", "vision_head_plain", "check_vision_head", "NORM_EPS"]

NORM_EPS = 1e-12
MAX_HIDDEN = 2048
MAX_HIDDEN_PLUS_EMBED = 11 * 1024


def vision_head_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    pooled = x.float().mean(dim=1)
    out = F.linear(pooled, weight.float(), bias.float())
    norm = torch.sqrt(torch.sum(out**2, dim=-1, keepdim=True))
    return out / torch.clamp(norm, min=NORM_EPS)


def check_vision_head(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    if x.dim() != 3:
        raise ValueError(f"vision_head: x must be [B, P, hidden], got {tuple(x.shape)}")
    B, P, h = x.shape
    if weight.dim() != 2 or weight.shape[1] != h or bias.shape != (weight.shape[0],):
        raise ValueError(f"vision_head: weight {tuple(weight.shape)}, bias {tuple(bias.shape)} for hidden {h}")
    e = weight.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32) or weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"vision_head: the kernel takes bf16 or f32 x and f32 weight and bias, "
                         f"got {x.dtype}, {weight.dtype}, {bias.dtype}")
    if h % 4 or not 0 < h <= MAX_HIDDEN or h + e > MAX_HIDDEN_PLUS_EMBED or P == 0:
        raise ValueError(f"vision_head: hidden {h} (divisible by 4, at most {MAX_HIDDEN}) "
                         f"+ embed_dim {e} must be at most {MAX_HIDDEN_PLUS_EMBED}, P > 0")
    if weight.data_ptr() % 16:
        raise ValueError("vision_head: weight must be 16-byte aligned")


def vision_head(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Mean-pooled, projected, normalised f32 ``[B, embed_dim]``; the kernel
    on a card, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return vision_head_plain(x, weight, bias)
    device = check_cuda("vision_head", x=x, weight=weight, bias=bias)
    check_vision_head(x, weight, bias)
    B, P, h = x.shape
    e = weight.shape[0]
    out = torch.empty((B, e), dtype=torch.float32, device=device)
    if B == 0:
        return out
    launch(
        "vision_head", _build.library("vision_head").pw_vision_head, device,
        x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, P, h, e, NORM_EPS,
    )
    vision_head.launches += 1
    return out


#: launches of the CUDA kernel in this process
vision_head.launches = 0
