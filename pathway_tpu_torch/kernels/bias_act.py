"""K4: a dense layer's epilogue, bias add + activation, in place
(``csrc/bias_act.cu``).

Replaces the bias add of every ``nn.Dense``/``nn.DenseGeneral`` in
``EncoderBlock``/``SelfAttention`` (``pathway_tpu/models/encoder.py:88-150``),
the ``nn.gelu`` after ``mlp_up`` and the pooler's ``jnp.tanh`` in
``CrossEncoderModel`` (``:222-224``).  flax's order: the product is
already rounded to the activation type; the f32 bias is cast to it and
added (rounding again); the activation is applied to the rounded sum and
rounded once more.  With ``pos`` (``[P, N]``, f32) it also replaces the
patch embed's tail in ``VisionEncoderModel`` (``pathway_tpu/models/vision.py:60-76``):
row ``r`` of ``y`` gets ``pos[r % P]`` cast to the activation type after
the bias, rounding once more, as ``x + pos.astype(dtype)`` does after the
conv's bias add.

:func:`bias_act` updates ``y`` (``[..., N]``, the fresh contiguous output
of ``F.linear``) in place and returns it.  For CUDA tensors it launches
the kernel (bf16 ``y``, f32 ``bias`` and ``pos``, N divisible by 8) and
raises on anything else; for CPU tensors it runs :func:`bias_act_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["bias_act", "bias_act_plain", "ACTS"]

#: activation name -> the kernel's code
ACTS = {"none": 0, "gelu_tanh": 1, "gelu_erf": 2, "tanh": 3}


def _activate(s: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu_tanh":
        return F.gelu(s, approximate="tanh")
    if act == "gelu_erf":
        return F.gelu(s)
    if act == "tanh":
        return torch.tanh(s)
    return s


def _pos_rows(y: torch.Tensor, pos: torch.Tensor | None) -> int:
    """Rows of ``pos``, checked against ``y``: ``[P, N]`` with P dividing
    the rows of ``y``."""
    if pos is None:
        return 0
    n = y.shape[-1]
    rows = y.numel() // n if n else 0
    if pos.dim() != 2 or pos.shape[1] != n or pos.shape[0] == 0 or rows % pos.shape[0]:
        raise ValueError(f"bias_act: pos {tuple(pos.shape)} must be [P, {n}] with P dividing {rows} rows")
    return pos.shape[0]


def bias_act_plain(
    y: torch.Tensor, bias: torch.Tensor, act: str, pos: torch.Tensor | None = None
) -> torch.Tensor:
    """``y = act(y + bias.to(y.dtype) (+ pos[r % P].to(y.dtype)))`` in
    place, each add rounded to ``y.dtype``, the activation taken in f32 on
    the rounded sum and rounded back."""
    if act not in ACTS:
        raise ValueError(f"bias_act: act {act!r} not in {sorted(ACTS)}")
    p = _pos_rows(y, pos)
    y.add_(bias.to(y.dtype))
    if p:
        y.view(-1, p, y.shape[-1]).add_(pos.to(y.dtype))
    if act != "none":
        y.copy_(_activate(y.float(), act))
    return y


def bias_act(
    y: torch.Tensor, bias: torch.Tensor, act: str = "none", pos: torch.Tensor | None = None
) -> torch.Tensor:
    """Bias add (+ position addend) + activation over the last dim of
    ``y``, in place; the kernel on a card, the plain version for CPU
    tensors."""
    if y.device.type == "cpu":
        return bias_act_plain(y, bias, act, pos)
    extra = {} if pos is None else {"pos": pos}
    device = check_cuda("bias_act", y=y, bias=bias, **extra)
    if act not in ACTS:
        raise ValueError(f"bias_act: act {act!r} not in {sorted(ACTS)}")
    n = y.shape[-1] if y.dim() else 0
    if bias.shape != (n,):
        raise ValueError(f"bias_act: bias {tuple(bias.shape)} != ({n},)")
    p = _pos_rows(y, pos)
    if y.dtype != torch.bfloat16 or bias.dtype != torch.float32 or (p and pos.dtype != torch.float32):
        raise ValueError(f"bias_act: the kernel takes bf16 y and f32 bias and pos, got {y.dtype}, {bias.dtype}")
    if n % 8 or y.data_ptr() % 16 or bias.data_ptr() % 16 or (p and pos.data_ptr() % 16):
        raise ValueError("bias_act: N must divide by 8 and y, bias, pos be 16-byte aligned")
    m = y.numel() // n if n else 0
    if m * n // 8 >= 2**31:
        raise ValueError(f"bias_act: {m} x {n} is too large for one launch")
    if m == 0:
        return y
    launch(
        "bias_act", _build.library("bias_act").pw_bias_act, device,
        y.data_ptr(), bias.data_ptr(), pos.data_ptr() if p else None, p, m, n, ACTS[act],
    )
    bias_act.launches += 1
    return y


#: launches of the CUDA kernel in this process
bias_act.launches = 0
