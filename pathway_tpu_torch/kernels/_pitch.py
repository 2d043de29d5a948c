"""Row pitch of the stored slabs.

K2, K3, K11 and K12 read rows by 16-byte loads and, in the tensor-core
passes, by TMA, whose global strides are whole 16 bytes.  An index whose
width ``d`` is not a multiple of that (770 f32 values, say) stores its
rows ``row_pitch(d)`` elements apart, the columns past ``d`` zero and
never written: a view ``[..., d]`` of ``[..., row_pitch(d)]`` storage.
Every reader sees ``d`` (``state_dict``, ``get``, ``dim``); a kernel
wrapper widens the view to the whole pitch (:func:`widen`) and pads its
queries with zeros, which leaves every inner product and distance as it
is.
"""

from __future__ import annotations

import torch

__all__ = ["ROW_ALIGN", "row_pitch", "pitched_zeros", "pitched", "widen", "flat_rows"]

#: elements a stored row is rounded up to: 16 bytes of bf16, 32 of f32
ROW_ALIGN = 8


def row_pitch(d: int) -> int:
    return -(-d // ROW_ALIGN) * ROW_ALIGN


def pitched_zeros(shape: tuple[int, ...], dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` whose last dim is stored :func:`row_pitch` wide."""
    *lead, d = shape
    full = torch.zeros((*lead, row_pitch(d)), dtype=dtype, device=device)
    return full if full.shape[-1] == d else full[..., :d]


def pitched(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in :func:`pitched_zeros` storage."""
    out = pitched_zeros(tuple(t.shape), t.dtype, t.device)
    out.copy_(t)
    return out


def widen(t: torch.Tensor, vec: int, name: str) -> torch.Tensor:
    """The view of ``t`` (``[..., d]``, rows a pitch apart, the leading
    dims dense over the pitch) over its whole pitch; raises unless the
    pitch is a multiple of ``vec`` elements."""
    d = t.shape[-1]
    pitch = t.stride(-2) if t.dim() > 1 else d
    if t.stride(-1) != 1 and d > 1:
        raise ValueError(f"{name}: rows must be contiguous along the last dim")
    if pitch < d or pitch % vec:
        raise ValueError(f"{name}: dim {d} with row pitch {pitch} must divide by {vec}: store "
                         f"the rows {vec}-aligned (kernels._pitch.pitched_zeros)")
    shape = (*t.shape[:-1], pitch)
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    strides = tuple(reversed(strides))
    if any(t.stride(i) != strides[i] for i in range(t.dim() - 1) if t.shape[i] > 1):
        raise ValueError(f"{name}: strides {t.stride()} are not rows of pitch {pitch}")
    return t if pitch == d and t.is_contiguous() else torch.as_strided(t, shape, strides)


def flat_rows(t: torch.Tensor) -> torch.Tensor:
    """``[..., n, d]`` pitched storage as the ``[rows, d]`` view of the same
    rows."""
    d = t.shape[-1]
    pitch = t.stride(-2)
    rows = t.numel() // d if d else 0
    return torch.as_strided(t, (rows, d), (pitch, 1))
