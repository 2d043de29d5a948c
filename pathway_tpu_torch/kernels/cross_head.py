"""B8: the cross-encoder's head, pooler Dense + tanh + classifier Dense,
in one launch (``csrc/cross_head.cu``).

Replaces the head of ``CrossEncoderModel.__call__``,
``pathway_tpu/models/encoder.py:222-231``: the CLS rows through the
``pooler`` ``nn.Dense(dtype=cfg.dtype)`` (the weight cast to the
activation type, the product rounded to it, the bias cast and added,
rounding again), ``jnp.tanh`` (taken in f32, rounded), then the
``classifier`` ``nn.Dense(dtype=f32)`` on the widened rows, its bias
added after the product.  In f32 every rounding is the identity.

:func:`cross_head` returns ``[B, labels]`` f32 from the CLS rows ``x``
``[B, hidden]`` (a strided view of the last hidden state, rows 16-byte
aligned, or any such tensor) and the two layers' parameters as torch
``Linear`` holds them (f32).  For CUDA tensors it launches the kernel
(bf16 or f32 ``x``, hidden a multiple of 64 up to 1,024, 1 to 64 labels)
and raises on anything else, as :func:`check_cross_head` says on any
device; for CPU tensors it runs :func:`cross_head_plain`, the chain the
kernel replaces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import launch
from pathway_tpu_torch.kernels.bias_act import bias_act_plain

__all__ = ["cross_head", "cross_head_plain", "check_cross_head", "DTYPES", "MAX_HIDDEN", "MAX_LABELS"]

#: the activation types the kernel takes
DTYPES = (torch.bfloat16, torch.float32)
#: hidden widths: multiples of 64 (8 blocks of a cluster, 8 columns a warp) up to this
MAX_HIDDEN = 1024
MAX_LABELS = 64
#: CLS rows a launch takes: rows index grid.y in clusters of 32
MAX_ROWS = 1 << 21


def cross_head_plain(
    x: torch.Tensor, pooler_w: torch.Tensor, pooler_b: torch.Tensor, cls_w: torch.Tensor, cls_b: torch.Tensor
) -> torch.Tensor:
    """The chain the kernel replaces: the pooler's product in the
    activation type, K4's plain bias + tanh, the classifier in f32."""
    h = bias_act_plain(F.linear(x, pooler_w.to(x.dtype)), pooler_b, "tanh")
    return F.linear(h.float(), cls_w.float(), cls_b.float())


def check_cross_head(
    x: torch.Tensor, pooler_w: torch.Tensor, pooler_b: torch.Tensor, cls_w: torch.Tensor, cls_b: torch.Tensor
) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, strides, types and alignment only, on any device."""
    if x.dim() != 2:
        raise ValueError(f"cross_head: x must be the CLS rows [B, hidden], got {tuple(x.shape)}")
    B, h = x.shape
    if pooler_w.shape != (h, h) or pooler_b.shape != (h,):
        raise ValueError(f"cross_head: pooler {tuple(pooler_w.shape)}, {tuple(pooler_b.shape)} for hidden {h}")
    if cls_w.dim() != 2 or cls_w.shape[1] != h or cls_b.shape != (cls_w.shape[0],):
        raise ValueError(f"cross_head: classifier {tuple(cls_w.shape)}, {tuple(cls_b.shape)} for hidden {h}")
    params = (pooler_w, pooler_b, cls_w, cls_b)
    if x.dtype not in DTYPES or any(p.dtype != torch.float32 for p in params):
        raise ValueError(f"cross_head: the kernel takes bf16 or f32 x and f32 parameters, "
                         f"got {x.dtype}, {[p.dtype for p in params]}")
    if h % 64 or not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"cross_head: hidden {h} must be a multiple of 64 up to {MAX_HIDDEN}")
    if not 1 <= cls_w.shape[0] <= MAX_LABELS:
        raise ValueError(f"cross_head: {cls_w.shape[0]} labels, the kernel takes 1 to {MAX_LABELS}")
    if B >= MAX_ROWS:
        raise ValueError(f"cross_head: {B} rows, at most {MAX_ROWS - 1} a launch")
    elem = x.element_size()
    if x.stride(1) != 1 or (x.stride(0) * elem) % 16 or x.data_ptr() % 16:
        raise ValueError(f"cross_head: x's rows must be contiguous and start 16-byte aligned, strides {x.stride()}")
    if any(not p.is_contiguous() for p in params) or any(p.data_ptr() % 16 for p in params[:3]):
        raise ValueError("cross_head: the parameters must be contiguous, the pooler's and the classifier's "
                         "weight and the pooler's bias 16-byte aligned")


def cross_head(
    x: torch.Tensor, pooler_w: torch.Tensor, pooler_b: torch.Tensor, cls_w: torch.Tensor, cls_b: torch.Tensor
) -> torch.Tensor:
    """``[B, labels]`` f32 logits of the CLS rows ``x``; one launch on a
    card, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return cross_head_plain(x, pooler_w, pooler_b, cls_w, cls_b)
    device = x.device
    tensors = (x, pooler_w, pooler_b, cls_w, cls_b)
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"cross_head: needs CUDA tensors on one device, got {sorted({str(t.device) for t in tensors})}")
    check_cross_head(x, pooler_w, pooler_b, cls_w, cls_b)
    B, h = x.shape
    labels = cls_w.shape[0]
    out = torch.empty((B, labels), dtype=torch.float32, device=device)
    if B == 0:
        return out
    launch(
        "cross_head", _build.library("cross_head").pw_cross_head, device,
        x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), pooler_w.data_ptr(), pooler_b.data_ptr(),
        cls_w.data_ptr(), cls_b.data_ptr(), out.data_ptr(), B, h, labels,
    )
    cross_head.launches += 1
    return out


#: launches of the CUDA kernel in this process
cross_head.launches = 0
