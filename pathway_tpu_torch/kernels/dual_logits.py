"""K10: the dual encoder's pairwise logits (``csrc/dual_logits.cu``).

Replaces ``DualEncoderModel.__call__``'s last line,
``pathway_tpu/models/vision.py:120``: ``img @ txt.T * exp(logit_scale) +
logit_bias`` in f32, in that order.

:func:`dual_logits` returns ``[n_img, n_txt]`` f32 from ``img``
``[n_img, D]`` and ``txt`` ``[n_txt, D]`` f32 and the two 0-d f32
parameters, which stay on the device.  For CUDA tensors it launches the
kernel (a width divisible by 4) and raises on anything else; for CPU tensors it runs
:func:`dual_logits_plain`.  The kernel takes the product on the tensor
cores in three TF32 passes (f32 accuracy, ``csrc/tf32x3.cuh``), d split
over the 8 blocks of a cluster and summed in a fixed order.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["dual_logits", "dual_logits_plain"]


def dual_logits_plain(
    img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor, logit_bias: torch.Tensor
) -> torch.Tensor:
    return torch.matmul(img, txt.T) * torch.exp(logit_scale) + logit_bias


def dual_logits(
    img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor, logit_bias: torch.Tensor
) -> torch.Tensor:
    """``img @ txt.T * exp(logit_scale) + logit_bias``; the kernel on a
    card, the plain version for CPU tensors."""
    if img.device.type == "cpu":
        return dual_logits_plain(img, txt, logit_scale, logit_bias)
    device = check_cuda("dual_logits", img=img, txt=txt, logit_scale=logit_scale, logit_bias=logit_bias)
    if img.dim() != 2 or txt.dim() != 2 or img.shape[1] != txt.shape[1] or img.shape[1] == 0:
        raise ValueError(f"dual_logits: img {tuple(img.shape)}, txt {tuple(txt.shape)}")
    if logit_scale.numel() != 1 or logit_bias.numel() != 1:
        raise ValueError("dual_logits: logit_scale and logit_bias must be scalars")
    if {img.dtype, txt.dtype, logit_scale.dtype, logit_bias.dtype} != {torch.float32}:
        raise ValueError("dual_logits: the kernel takes f32 embeddings and parameters")
    if img.shape[1] % 4 or img.data_ptr() % 16 or txt.data_ptr() % 16:
        raise ValueError("dual_logits: the kernel takes a width divisible by 4 and 16-byte aligned rows")
    m, n = img.shape[0], txt.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if m == 0 or n == 0:
        return out
    launch(
        "dual_logits", _build.library("dual_logits").pw_dual_logits, device,
        img.data_ptr(), txt.data_ptr(), logit_scale.data_ptr(), logit_bias.data_ptr(),
        out.data_ptr(), m, n, img.shape[1],
    )
    dual_logits.launches += 1
    return out


#: launches of the CUDA kernel in this process
dual_logits.launches = 0
