"""K8: the vision tower's patchify (``csrc/patchify.cu``).

Replaces the input side of the patch-embed ``nn.Conv`` in
``VisionEncoderModel.__call__``, ``pathway_tpu/models/vision.py:60-69``:
the images cast to the activation type (``:68``), flax's default
``"SAME"`` padding, and the stride-``p`` grid of ``p x p`` patches.  Each
patch becomes one row of ``p * p * C`` values in the HWIO kernel's
``(kh, kw, c)`` order, rows in the conv output's row-major
``(h_out, w_out)`` order, so the conv is this ``[B * P, p * p * C]`` matrix
times the kernel reshaped to ``[p * p * C, hidden]``.

:func:`patchify` takes NHWC images (the JAX layout) and returns the
patch rows.  For CUDA tensors it launches the kernel (f32 or uint8
images; bf16 output with ``patch * patch * C`` divisible by 8, or f32
output with it divisible by 4) and raises on anything else, as
:func:`check_patchify` says on any device; for CPU tensors it runs
:func:`patchify_plain`.  :func:`patch_grid` gives the grid and the
padding of an image size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["patchify", "patchify_plain", "patch_grid", "check_patchify"]

#: image dtype -> the kernel's code for it
_IMAGE_KINDS = {torch.float32: 0, torch.uint8: 1}
#: output dtype -> values in one 16-byte store of the kernel
_OUT_VEC = {torch.bfloat16: 8, torch.float32: 4}


def patch_grid(height: int, width: int, patch: int) -> tuple[int, int, int, int]:
    """``(gh, gw, pad_top, pad_left)`` of a stride-``patch`` conv with
    ``"SAME"`` padding (``jax.lax.padtype_to_pads``): ``ceil(side / patch)``
    patches a side, the padding split with the smaller half first."""
    gh, gw = -(-height // patch), -(-width // patch)
    return gh, gw, (gh * patch - height) // 2, (gw * patch - width) // 2


def _check(images: torch.Tensor, patch: int) -> None:
    if images.dim() != 4:
        raise ValueError(f"patchify: images must be [B, H, W, C], got {tuple(images.shape)}")
    if patch <= 0:
        raise ValueError(f"patchify: patch {patch} must be positive")


def patchify_plain(images: torch.Tensor, patch: int, dtype: torch.dtype) -> torch.Tensor:
    _check(images, patch)
    B, H, W, C = images.shape
    gh, gw, top, left = patch_grid(H, W, patch)
    x = images.to(dtype)
    x = F.pad(x, (0, 0, left, gw * patch - W - left, top, gh * patch - H - top))
    x = x.view(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * gh * gw, patch * patch * C)


def check_patchify(images: torch.Tensor, patch: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    _check(images, patch)
    if dtype not in _OUT_VEC:
        raise ValueError(f"patchify: the kernel writes bf16 or f32, asked for {dtype}")
    if images.dtype not in _IMAGE_KINDS:
        raise ValueError(f"patchify: the kernel takes f32 or uint8 images, got {images.dtype}")
    if images.data_ptr() % 16:
        raise ValueError("patchify: images must be 16-byte aligned")
    B, H, W, C = images.shape
    gh, gw, _, _ = patch_grid(H, W, patch)
    cols, vec = patch * patch * C, _OUT_VEC[dtype]
    if cols % vec:
        raise ValueError(f"patchify: the kernel writes {dtype} rows of {vec}-value vectors; "
                         f"patch {patch} x {C} channels gives {cols}")
    if B * gh * gw * cols >= 2**31:
        raise ValueError(f"patchify: [{B * gh * gw}, {cols}] is too large for one launch")


def patchify(
    images: torch.Tensor, patch: int, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Patch rows ``[B * gh * gw, patch * patch * C]`` in ``dtype`` of NHWC
    ``images``; the kernel on a card, the plain version for CPU tensors."""
    if images.device.type == "cpu":
        return patchify_plain(images, patch, dtype)
    device = check_cuda("patchify", images=images)
    check_patchify(images, patch, dtype)
    B, H, W, C = images.shape
    gh, gw, top, left = patch_grid(H, W, patch)
    out = torch.empty((B * gh * gw, patch * patch * C), dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    launch(
        "patchify", _build.library("patchify").pw_patchify, device,
        images.data_ptr(), _IMAGE_KINDS[images.dtype], out.data_ptr(), int(dtype == torch.float32),
        B, H, W, C, patch, gh, gw, top, left,
    )
    patchify.launches += 1
    return out


#: launches of the CUDA kernel in this process
patchify.launches = 0
