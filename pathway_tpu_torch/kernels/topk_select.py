"""K13: exact top-k of each row of an f32 score array (``csrc/topk_select.cu``).

Replaces ``jax.lax.top_k`` where k is above what K3's per-tile selection
takes (:data:`~pathway_tpu_torch.kernels.knn_topk.MAX_K`): the masked
top-k of ``pathway_tpu/parallel/sharded_knn.py:336-341`` and of its mesh
branch's global top-k (``:370-375``), and the IVF's probe and cell
top-k (``pathway_tpu/parallel/ivf_knn.py:320-336``).  ``vals [nq, n]``
f32 (masked entries already ``NEG_INF``) gives ``(values [nq, k] f32,
ids [nq, k] int32)``, best first, ties to the lower position as
``jax.lax.top_k`` gives them; an id is ``ids[row, pos]`` when ``ids
[nq, n]`` int32 is given (a reduction of candidate lists), else ``pos +
offset`` (a row of slot scores, ``offset`` a shard's first slot).

For CUDA tensors the wrapper launches the radix select (any ``1 <= k <=
n``): twelve small kernels on the current stream, each row cut into
chunks so that a few rows still fill the card; each adds one to
``topk_select.launches``.  For CPU tensors it runs
:func:`topk_select_plain`, ``ops.topk.masked_top_k`` over the same array.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.ops.topk import masked_top_k

__all__ = ["topk_select", "topk_select_plain"]

_STEP = 4096  # scores a 256-thread block reads per step (csrc kThreads * 4 * kUnroll)
_BLOCKS = 528  # blocks a select aims for: 4 per SM of an H100's 132


def topk_select_plain(
    vals: torch.Tensor, k: int, ids: torch.Tensor | None = None, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    v, pos = masked_top_k(vals, None, k)
    out = torch.gather(ids, 1, pos) if ids is not None else pos + offset
    return v, out.to(torch.int32)


def topk_select(
    vals: torch.Tensor, k: int, ids: torch.Tensor | None = None, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The best ``k`` of each row of ``vals``, with their ids."""
    if vals.dim() != 2 or (ids is not None and ids.shape != vals.shape):
        raise ValueError(
            f"topk_select: vals {tuple(vals.shape)}, ids {None if ids is None else tuple(ids.shape)}"
        )
    nq, n = vals.shape
    if not 1 <= k <= n:
        raise ValueError(f"topk_select: k={k} outside 1..{n} (row length)")
    if vals.device.type == "cpu":
        return topk_select_plain(vals, k, ids, offset)
    tensors = {"vals": vals} if ids is None else {"vals": vals, "ids": ids}
    device = check_cuda("topk_select", **tensors)
    if vals.dtype != torch.float32 or (ids is not None and ids.dtype != torch.int32):
        raise ValueError("topk_select: vals must be f32 and ids int32")
    if n >= 2**31 - 2**16 or nq > 65535:
        raise ValueError(f"topk_select: [{nq}, {n}] past the kernel's int32 positions or grid")
    out_vals = torch.empty((nq, k), device=device)
    out_ids = torch.empty((nq, k), dtype=torch.int32, device=device)
    if nq == 0:
        return out_vals, out_ids
    kpow = 1 << (k - 1).bit_length()
    splits = max(1, min(-(-n // _STEP), -(-_BLOCKS // nq)))
    chunk = -(-n // splits)
    chunk += -chunk % 4
    splits = -(-n // chunk)
    scratch_i = torch.empty((nq * (256 + 8 + kpow + splits),), dtype=torch.int32, device=device)
    scratch_f = torch.empty((nq * kpow,), device=device)
    lib = _build.library("topk_select")
    launch(
        "topk_select", lib.pw_topk_select, device,
        vals.data_ptr(), None if ids is None else ids.data_ptr(),
        out_vals.data_ptr(), out_ids.data_ptr(), scratch_i.data_ptr(), scratch_f.data_ptr(),
        nq, n, k, kpow, splits, chunk, offset,
    )
    topk_select.launches += lib.pw_topk_select_launches()
    return out_vals, out_ids


#: CUDA kernels launched in this process (twelve per call)
topk_select.launches = 0
