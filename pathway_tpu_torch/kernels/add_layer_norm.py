"""K5: fused residual add + LayerNorm (``csrc/add_layer_norm.cu``).

Replaces the two ``nn.LayerNorm(x + a)`` of ``EncoderBlock.__call__``,
``pathway_tpu/models/encoder.py:128-150``: ``s = x + r`` rounded to the
activation type, statistics of ``s`` in f32, the normalised row rounded
back.  The kernel takes the variance in two passes over registers, as
:func:`layer_norm_plain` (``F.layer_norm``) does; flax takes
E[s^2] - E[s]^2.  On post-residual rows the two differ by a few f32 ulps
of the variance, within the bf16 tolerance the port is held to.

:func:`add_layer_norm` returns a new ``[..., H]`` tensor.  For CUDA
tensors it launches the kernel (bf16 or f32 ``x``/``r`` of one type, f32
``scale``/``bias``, H divisible by 8 and at most 1024) and raises on
anything else (:func:`check_add_layer_norm` says what it takes); for CPU
tensors it runs :func:`add_layer_norm_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = [
    "add_layer_norm", "add_layer_norm_plain", "check_add_layer_norm", "layer_norm_plain",
    "MAX_HIDDEN", "DTYPES", "layer_norm_bwd", "layer_norm_bwd_plain", "AddLayerNormFunction", "bwd_grid",
]

MAX_HIDDEN = 1024
#: the activation types the kernels K5 and K6 take
DTYPES = (torch.bfloat16, torch.float32)


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


def check_add_layer_norm(
    x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    if r.shape != x.shape or x.dim() == 0:
        raise ValueError(f"add_layer_norm: x {tuple(x.shape)} and r {tuple(r.shape)} differ")
    if x.dtype not in DTYPES or r.dtype != x.dtype:
        raise ValueError(f"add_layer_norm: the kernel takes bf16 or f32 x and r of one type, "
                         f"got {x.dtype}, {r.dtype}")
    check_norm_params("add_layer_norm", x.shape[-1], scale, bias)
    if x.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("add_layer_norm: x and r must be 16-byte aligned")


def add_layer_norm(
    x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """``LayerNorm(x + r)`` over the last dim; the kernel on a card, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, r, scale, bias, eps)
    device = check_cuda("add_layer_norm", x=x, r=r, scale=scale, bias=bias)
    check_add_layer_norm(x, r, scale, bias)
    out = torch.empty_like(x)
    h = x.shape[-1]
    m = x.numel() // h
    if m == 0:
        return out
    launch(
        "add_layer_norm", _build.library("add_layer_norm").pw_add_layer_norm, device,
        x.data_ptr(), r.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        m, h, float(eps), int(x.dtype == torch.float32),
    )
    add_layer_norm.launches += 1
    return out


#: launches of the CUDA kernel in this process
add_layer_norm.launches = 0


# ---------------------------------------------------------------------------
# K17: the backward (csrc/layer_norm_bwd.cu), and K5's autograd Function

#: K17's two forms, as ``pw_layer_norm_bwd_grid`` numbers them
RESIDUAL, EMBEDDING = 0, 1
#: (card index, form, hidden) -> the most blocks the card holds at once
_grids: dict[tuple[int, int, int], int] = {}


def bwd_grid(form: int, h: int, device: torch.device) -> int:
    """The most blocks of K17's ``form`` at width ``h`` that ``device``
    holds at once: the largest grid of its cooperative launch (each block
    writes one partial row of dgamma and dbeta).  Asked of the library
    once per card, form and width."""
    key = (device.index, form, h)
    blocks = _grids.get(key)
    if blocks is None:
        with torch.cuda.device(device.index):
            blocks = _build.library("layer_norm_bwd").pw_layer_norm_bwd_grid(form, h)
        if blocks <= 0:
            raise RuntimeError(f"layer_norm_bwd: no grid for form {form} at hidden {h} (cudaError_t {-blocks})")
        _grids[key] = blocks
    return blocks


def layer_norm_bwd_plain(
    dy: torch.Tensor, s: torch.Tensor, gamma: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ds, dgamma, dbeta)`` of LayerNorm over the last dim of ``s`` (f32),
    the statistics taken again from ``s`` as the forward takes them."""
    h = s.shape[-1]
    mean = s.mean(-1, keepdim=True)
    var = ((s - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (s - mean) * rstd
    g = dy * gamma
    ds = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return ds, (dy * xhat).reshape(-1, h).sum(0), dy.reshape(-1, h).sum(0)


def layer_norm_bwd(
    dy: torch.Tensor, x: torch.Tensor, r: torch.Tensor | None, gamma: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's backward: ``(ds, dgamma, dbeta)`` of ``LayerNorm(x + r)``, ds the
    gradient of both x and r; the kernel on a card (one cooperative launch:
    the rows, then the blocks' partial dgamma and dbeta summed in order),
    the plain version for CPU tensors."""
    if dy.device.type == "cpu":
        return layer_norm_bwd_plain(dy, x if r is None else x + r, gamma, eps)
    tensors = {"dy": dy, "x": x, "gamma": gamma} | ({} if r is None else {"r": r})
    device = check_cuda("layer_norm_bwd", **tensors)
    h = x.shape[-1]
    m = x.numel() // h
    if any(t.dtype != torch.float32 for t in tensors.values()) or dy.shape != x.shape or \
            (r is not None and r.shape != x.shape) or gamma.shape != (h,):
        raise ValueError(f"layer_norm_bwd: f32 dy, x, r {tuple(x.shape)} and gamma [{h}]")
    if h % 8 or not 0 < h <= MAX_HIDDEN or any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError(f"layer_norm_bwd: hidden {h} must divide by 8 and be at most {MAX_HIDDEN}, 16-byte aligned")
    ds = torch.empty_like(x)
    d_gamma = torch.empty((h,), dtype=torch.float32, device=device)
    d_beta = torch.empty((h,), dtype=torch.float32, device=device)
    if m == 0:
        return ds, d_gamma.zero_(), d_beta.zero_()
    blocks = min(bwd_grid(RESIDUAL, h, device), -(-m // 8))
    partial = torch.empty((2, blocks, h), dtype=torch.float32, device=device)
    launch(
        "layer_norm_bwd", _build.library("layer_norm_bwd").pw_layer_norm_bwd, device,
        x.data_ptr(), None if r is None else r.data_ptr(), dy.data_ptr(), gamma.data_ptr(), ds.data_ptr(),
        partial.data_ptr(), d_gamma.data_ptr(), d_beta.data_ptr(), m, h, float(eps), blocks,
    )
    layer_norm_bwd.launches += 1
    return ds, d_gamma, d_beta


#: launches of the CUDA kernel in this process (one a call)
layer_norm_bwd.launches = 0


class AddLayerNormFunction(torch.autograd.Function):
    """K5 forward, K17 backward.  The forward keeps its inputs x and r (the
    backward takes the statistics again from x + r).  Training runs in
    f32: a bf16 call runs K5 and its backward raises."""

    @staticmethod
    def forward(ctx, x, r, scale, bias, eps):
        ctx.eps = eps
        ctx.trained = x.dtype == torch.float32
        if ctx.trained:
            ctx.save_for_backward(x, r, scale)
        return add_layer_norm(x, r, scale, bias, eps)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.trained:
            raise NotImplementedError("add_layer_norm: the backward kernels take f32; bf16 is not trained")
        x, r, scale = ctx.saved_tensors
        ds, d_gamma, d_beta = layer_norm_bwd(dout.contiguous(), x, r, scale, ctx.eps)
        return ds, ds, d_gamma, d_beta, None
