"""K5: fused residual add + LayerNorm (``csrc/add_layer_norm.cu``).

Replaces the two ``nn.LayerNorm(x + a)`` of ``EncoderBlock.__call__``,
``pathway_tpu/models/encoder.py:128-150``: ``s = x + r`` rounded to the
activation type, statistics of ``s`` in f32, the normalised row rounded
back.  The kernel takes the variance in two passes over registers, as
:func:`layer_norm_plain` (``F.layer_norm``) does; flax takes
E[s^2] - E[s]^2.  On post-residual rows the two differ by a few f32 ulps
of the variance, within the bf16 tolerance the port is held to.

:func:`add_layer_norm` returns a new ``[..., H]`` tensor.  For CUDA
tensors it launches the kernel (bf16 ``x``/``r``, f32 ``scale``/``bias``,
H divisible by 8 and at most 1024) and raises on anything else; for CPU
tensors it runs :func:`add_layer_norm_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["add_layer_norm", "add_layer_norm_plain", "layer_norm_plain", "MAX_HIDDEN"]

MAX_HIDDEN = 1024


def layer_norm_plain(
    s: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """flax ``LayerNorm(dtype=s.dtype)``: f32 statistics, result cast back."""
    y = F.layer_norm(s.float(), (s.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(s.dtype)


def add_layer_norm_plain(
    x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    return layer_norm_plain(x + r, scale, bias, eps)


def check_norm_params(name: str, h: int, scale: torch.Tensor, bias: torch.Tensor) -> None:
    """The kernels' LayerNorm parameters: f32 ``[h]``, ``h`` a multiple of 8
    up to :data:`MAX_HIDDEN`, 16-byte aligned."""
    if scale.shape != (h,) or bias.shape != (h,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} / bias {tuple(bias.shape)} != ({h},)")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"{name}: scale and bias must be f32")
    if h % 8 or not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {h} must divide by 8 and be at most {MAX_HIDDEN}")
    if scale.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError(f"{name}: scale and bias must be 16-byte aligned")


def add_layer_norm(
    x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """``LayerNorm(x + r)`` over the last dim; the kernel on a card, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, r, scale, bias, eps)
    device = check_cuda("add_layer_norm", x=x, r=r, scale=scale, bias=bias)
    if r.shape != x.shape or x.dim() == 0:
        raise ValueError(f"add_layer_norm: x {tuple(x.shape)} and r {tuple(r.shape)} differ")
    if x.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
        raise ValueError(f"add_layer_norm: the kernel takes bf16 x and r, got {x.dtype}, {r.dtype}")
    h = x.shape[-1]
    check_norm_params("add_layer_norm", h, scale, bias)
    if x.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("add_layer_norm: x and r must be 16-byte aligned")
    out = torch.empty_like(x)
    m = x.numel() // h
    if m == 0:
        return out
    launch(
        "add_layer_norm", _build.library("add_layer_norm").pw_add_layer_norm, device,
        x.data_ptr(), r.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        m, h, float(eps),
    )
    add_layer_norm.launches += 1
    return out


#: launches of the CUDA kernel in this process
add_layer_norm.launches = 0
