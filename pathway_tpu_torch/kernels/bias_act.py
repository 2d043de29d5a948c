"""K4: a dense layer's epilogue, bias add + activation, in place
(``csrc/bias_act.cu``).

Replaces the bias add of every ``nn.Dense``/``nn.DenseGeneral`` in
``EncoderBlock``/``SelfAttention`` (``pathway_tpu/models/encoder.py:88-150``),
the ``nn.gelu`` after ``mlp_up`` and, where the cross-encoder's head is
trained, the pooler's ``jnp.tanh`` in ``CrossEncoderModel`` (``:222-224``;
outside training the head is one ``cross_head`` launch).  flax's order: the product is
already rounded to the activation type; the f32 bias is cast to it and
added (rounding again); the activation is applied to the rounded sum and
rounded once more.  With ``pos`` (``[P, N]``, f32) it also replaces the
patch embed's tail in ``VisionEncoderModel`` (``pathway_tpu/models/vision.py:60-76``):
row ``r`` of ``y`` gets ``pos[r % P]`` cast to the activation type after
the bias, rounding once more, as ``x + pos.astype(dtype)`` does after the
conv's bias add.

:func:`bias_act` updates ``y`` (``[..., N]``, the fresh contiguous output
of ``F.linear``) in place and returns it.  For CUDA tensors it launches
the kernel (bf16 or f32 ``y``, f32 ``bias`` and ``pos``, N divisible by 8)
and raises on anything else (:func:`check_bias_act` says what it takes);
for CPU tensors it runs :func:`bias_act_plain`.  In f32 every rounding
is the identity, as flax ``Dense(dtype=f32)`` has it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build, _launch
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = [
    "bias_act", "bias_act_plain", "check_bias_act", "ACTS", "DTYPES",
    "bias_act_bwd", "bias_act_bwd_plain", "act_grad", "BiasActFunction",
]

#: activation name -> the kernel's code
ACTS = {"none": 0, "gelu_tanh": 1, "gelu_erf": 2, "tanh": 3}
#: the activation types the kernel takes
DTYPES = (torch.bfloat16, torch.float32)


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


def check_bias_act(
    y: torch.Tensor, bias: torch.Tensor, act: str, pos: torch.Tensor | None = None
) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    if act not in ACTS:
        raise ValueError(f"bias_act: act {act!r} not in {sorted(ACTS)}")
    n = y.shape[-1] if y.dim() else 0
    if bias.shape != (n,):
        raise ValueError(f"bias_act: bias {tuple(bias.shape)} != ({n},)")
    p = _pos_rows(y, pos)
    if y.dtype not in DTYPES or bias.dtype != torch.float32 or (p and pos.dtype != torch.float32):
        raise ValueError(f"bias_act: the kernel takes bf16 or f32 y and f32 bias and pos, "
                         f"got {y.dtype}, {bias.dtype}")
    if n % 8 or y.data_ptr() % 16 or bias.data_ptr() % 16 or (p and pos.data_ptr() % 16):
        raise ValueError("bias_act: N must divide by 8 and y, bias, pos be 16-byte aligned")
    m = y.numel() // n if n else 0
    if m * n // 8 >= 2**31:
        raise ValueError(f"bias_act: {m} x {n} is too large for one launch")


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
    check_bias_act(y, bias, act, pos)
    n = y.shape[-1]
    m = y.numel() // n
    if m == 0:
        return y
    p = _pos_rows(y, pos)
    launch(
        "bias_act", _build.library("bias_act").pw_bias_act, device,
        y.data_ptr(), bias.data_ptr(), pos.data_ptr() if p else None, p, m, n, ACTS[act],
        int(y.dtype == torch.float32),
    )
    bias_act.launches += 1
    bias_act.launches_by_act[act] += 1
    return y


#: launches of the CUDA kernel in this process, and by activation
bias_act.launches = 0
bias_act.launches_by_act = dict.fromkeys(ACTS, 0)


# ---------------------------------------------------------------------------
# K16: the backward (csrc/bias_act_bwd.cu), and K4's autograd Function

#: blocks the backward's first pass aims for (8 an SM of an H100)
_BWD_BLOCKS = 1056


def act_grad(s: torch.Tensor, act: str) -> torch.Tensor:
    """The derivative of ``act`` at ``s`` (f32), as the kernel takes it."""
    if act == "gelu_tanh":
        k0, k1 = 0.7978845608028654, 0.044715
        t = torch.tanh(k0 * (s + k1 * s * s * s))
        return 0.5 * (1.0 + t) + 0.5 * s * (1.0 - t * t) * k0 * (1.0 + 3.0 * k1 * s * s)
    if act == "gelu_erf":
        return 0.5 * (1.0 + torch.erf(s / math.sqrt(2.0))) + s * torch.exp(-0.5 * s * s) / math.sqrt(2.0 * math.pi)
    if act == "tanh":
        t = torch.tanh(s)
        return 1.0 - t * t
    return torch.ones_like(s)


def bias_act_bwd_plain(
    dy: torch.Tensor, y: torch.Tensor | None, bias: torch.Tensor, act: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, db)``: ``dx = dy * act'(y + bias)`` (``dy`` itself for act
    none, where ``y`` is not read), ``db`` its sum over the rows."""
    dx = dy if act == "none" else dy * act_grad(y + bias, act)
    return dx, dx.reshape(-1, dx.shape[-1]).sum(0)


#: act none's ``db`` comes from blocks of this many rows (see :func:`_db_row`)
_DB_ROWS = 64
#: (card, stream handle, N) -> the rows of its newest block not yet handed out
_db_rows: dict[tuple[int, int, int], list[torch.Tensor]] = {}


def _db_row(device: torch.device, n: int) -> torch.Tensor:
    """A new ``[n]`` f32 tensor for act none's ``db``: one row of a
    ``[_DB_ROWS, n]`` block allocated on the current stream, the next block
    once the rows are spent.  An allocation takes longer on the host than
    act none's column sum on the card, so it is made once for 64 calls.
    Each row is handed out once; the block is freed with its last row."""
    key = (device.index, _launch._raw_stream(device.index), n)
    rows = _db_rows.get(key)
    if not rows:
        rows = _db_rows[key] = list(torch.empty((_DB_ROWS, n), device=device).unbind(0))
    return rows.pop()


def bias_act_bwd(
    dy: torch.Tensor, y: torch.Tensor | None, bias: torch.Tensor, act: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's backward from the product before the bias ``y`` (f32); the
    kernel on a card, the plain version for CPU tensors.  Act none is one
    launch that writes ``db`` alone (``dx`` is ``dy``) into a row from
    :func:`_db_row`; an activation two: dx and the blocks' partial db, then
    their sum."""
    if act not in ACTS:
        raise ValueError(f"bias_act_bwd: act {act!r} not in {sorted(ACTS)}")
    if dy.is_cpu:
        return bias_act_bwd_plain(dy, y, bias, act)
    n = dy.shape[-1]
    if act == "none":  # 60 of the train step's 72 calls: the host path kept short
        if not (dy.is_cuda and bias.is_cuda and bias.get_device() == dy.get_device() and dy.is_contiguous()
                and bias.is_contiguous()):
            check_cuda("bias_act_bwd", dy=dy, bias=bias)  # raises, naming the fault
        if dy.dtype != torch.float32 or bias.dtype != torch.float32 or bias.shape != (n,):
            raise ValueError(f"bias_act_bwd: f32 dy {tuple(dy.shape)} and bias [{n}]")
        ptr = dy.data_ptr()
        if not n or n % 8 or ptr % 16:
            raise ValueError("bias_act_bwd: N must be a positive multiple of 8 and dy 16-byte aligned")
        device = dy.device
        db = _db_row(device, n)
        launch("bias_act_bwd", _build.library("bias_act_bwd").pw_bias_sum, device, ptr, db.data_ptr(),
               dy.numel() // n, n)
        bias_act_bwd.launches += 1
        return dy, db
    m = dy.numel() // n if n else 0
    tensors = {"dy": dy, "y": y, "bias": bias}
    device = check_cuda("bias_act_bwd", **tensors)
    if any(t.dtype != torch.float32 for t in tensors.values()) or bias.shape != (n,) or y.shape != dy.shape:
        raise ValueError(f"bias_act_bwd: f32 dy {tuple(dy.shape)}, y and bias [{n}]")
    if n % 8 or any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError("bias_act_bwd: N must divide by 8 and the tensors be 16-byte aligned")
    db = torch.empty_like(bias)
    dx = torch.empty_like(dy)
    chunks = max(1, min(m, 65535, _BWD_BLOCKS // -(-n // 128)))
    partial = torch.empty((chunks, n), dtype=torch.float32, device=device)
    launch(
        "bias_act_bwd", _build.library("bias_act_bwd").pw_bias_act_bwd, device,
        dy.data_ptr(), y.data_ptr(), bias.data_ptr(), dx.data_ptr(), partial.data_ptr(), db.data_ptr(),
        m, n, ACTS[act], chunks,
    )
    bias_act_bwd.launches += 2
    return dx, db


#: launches of the CUDA kernels in this process (one a call with act none,
#: two with an activation)
bias_act_bwd.launches = 0


class BiasActFunction(torch.autograd.Function):
    """K4 forward (in place, as :func:`bias_act`), K16 backward.  K4
    overwrites ``y``, so the forward copies the product first where the
    backward needs it (an activation); with act none it keeps nothing but
    the bias.  Training runs in f32: a bf16 call runs K4 and its backward
    raises."""

    @staticmethod
    def forward(ctx, y, bias, act):
        ctx.act = act
        ctx.trained = y.dtype == torch.float32
        pre = y.clone() if ctx.trained and act != "none" else None
        ctx.save_for_backward(pre, bias)
        bias_act(y, bias, act)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        if not ctx.trained:
            raise NotImplementedError("bias_act: the backward kernels take f32; bf16 is not trained")
        pre, bias = ctx.saved_tensors
        dx, db = bias_act_bwd(dy.contiguous(), pre, bias, ctx.act)
        return dx, db, None
