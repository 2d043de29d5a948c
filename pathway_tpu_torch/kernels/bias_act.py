"""K4: a dense layer's epilogue, bias add + activation, in place
(``csrc/bias_act.cu``).

Replaces the bias add of every ``nn.Dense``/``nn.DenseGeneral`` in
``EncoderBlock``/``SelfAttention`` (``pathway_tpu/models/encoder.py:88-150``),
the ``nn.gelu`` after ``mlp_up`` and the pooler's ``jnp.tanh`` in
``CrossEncoderModel`` (``:222-224``).  flax's order: the product is
already rounded to the activation type; the f32 bias is cast to it and
added (rounding again); the activation is applied to the rounded sum and
rounded once more.

:func:`bias_act` updates ``y`` (``[..., N]``, the fresh contiguous output
of ``F.linear``) in place and returns it.  For CUDA tensors it launches
the kernel (bf16 ``y``, f32 ``bias``, N divisible by 8) and raises on
anything else; for CPU tensors it runs :func:`bias_act_plain`.
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


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """``y = act(y + bias.to(y.dtype))`` in place, the activation taken in
    f32 on the rounded sum and rounded back to ``y.dtype``."""
    if act not in ACTS:
        raise ValueError(f"bias_act: act {act!r} not in {sorted(ACTS)}")
    y.add_(bias.to(y.dtype))
    if act != "none":
        y.copy_(_activate(y.float(), act))
    return y


def bias_act(y: torch.Tensor, bias: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Bias add + activation over the last dim of ``y``, in place; the
    kernel on a card, the plain version for CPU tensors."""
    if y.device.type == "cpu":
        return bias_act_plain(y, bias, act)
    device = check_cuda("bias_act", y=y, bias=bias)
    if act not in ACTS:
        raise ValueError(f"bias_act: act {act!r} not in {sorted(ACTS)}")
    n = y.shape[-1] if y.dim() else 0
    if bias.shape != (n,):
        raise ValueError(f"bias_act: bias {tuple(bias.shape)} != ({n},)")
    if y.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise ValueError(f"bias_act: the kernel takes bf16 y and f32 bias, got {y.dtype}, {bias.dtype}")
    if n % 8 or y.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("bias_act: N must divide by 8 and y, bias be 16-byte aligned")
    m = y.numel() // n if n else 0
    if m * n // 8 >= 2**31:
        raise ValueError(f"bias_act: {m} x {n} is too large for one launch")
    if m == 0:
        return y
    launch(
        "bias_act", _build.library("bias_act").pw_bias_act, device,
        y.data_ptr(), bias.data_ptr(), m, n, ACTS[act],
    )
    bias_act.launches += 1
    return y


#: launches of the CUDA kernel in this process
bias_act.launches = 0
