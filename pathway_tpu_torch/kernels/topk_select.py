"""K13: exact top-k of each row of an f32 score array (``csrc/topk_select.cu``).

Replaces ``jax.lax.top_k`` where k is above what K3's per-tile selection
takes (:data:`~pathway_tpu_torch.kernels.knn_topk.MAX_K`): the masked
top-k of ``pathway_tpu/parallel/sharded_knn.py:336-341`` and of its mesh
branch's global top-k (``:370-375``), and the IVF's probe and cell
top-k (``pathway_tpu/parallel/ivf_knn.py:320-336``).  ``vals [nq, n]``
f32 (masked entries already ``NEG_INF``) gives ``(values [nq, k] f32,
ids [nq, k] int32)``, best first, ties to the lower position as
``jax.lax.top_k`` gives them (-0 ranks with +0); an id is ``ids[row,
pos]`` when ``ids [nq, n]`` int32 is given (a reduction of candidate
lists), else ``pos + offset`` (a row of slot scores, ``offset`` a shard's
first slot).

For CUDA tensors the wrapper launches the radix select (any ``1 <= k <=
n``, k up to 2^30): six kernels on the current stream, each row cut into
chunks so that a few rows still fill the card (:func:`select_plan`); each
adds one to ``topk_select.launches``.  For CPU tensors it runs
:func:`topk_select_plain`.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch

__all__ = ["topk_select", "topk_select_plain", "select_plan", "MAX_ROWS", "MAX_LEN", "MAX_SLOTS"]

_STEP = 4096  # scores a 256-thread block reads per step (csrc kThreads * 4 * kUnroll)
_BLOCKS = 528  # blocks a select aims for: 4 per SM of an H100's 132
_BINS = 2048  # csrc kBins: one 11-bit digit's histogram per row
_STATE = 16  # csrc RowState, in ints
_SMEM_SORT = 4096  # csrc kSmemSort: the candidate buffer's least size

#: the kernel's grid takes at most this many rows
MAX_ROWS = 65535
#: positions are int32, with room for a block's last step past the end
MAX_LEN = 2**31 - 2**16 - 1
#: a row's winner and candidate slots are int32 indices
MAX_SLOTS = 2**30


def select_plan(nq: int, n: int, k: int) -> dict:
    """How the kernel runs ``[nq, n]`` at ``k``; raises ``ValueError`` on
    what it does not take.  ``slots``: each row's winner and candidate
    buffer, a power of two (at least k, and 4,096 unless n is smaller), so
    that a bin of the k-th best with up to ``slots - (winners above it)``
    entries is sorted with the winners; ``splits`` chunks of ``chunk``
    entries (a multiple of 4) per row; the int32 and f32 scratch sizes."""
    if not 1 <= k <= n:
        raise ValueError(f"topk_select: k={k} outside 1..{n} (row length)")
    if n > MAX_LEN or nq > MAX_ROWS:
        raise ValueError(f"topk_select: [{nq}, {n}] past the kernel's int32 positions or grid")
    kpow = 1 << (k - 1).bit_length()
    slots = min(max(kpow, _SMEM_SORT), 1 << (n - 1).bit_length())
    if slots > MAX_SLOTS:
        raise ValueError(f"topk_select: k={k} needs {slots} slots a row, past the kernel's {MAX_SLOTS}")
    splits = max(1, min(-(-n // _STEP), -(-_BLOCKS // max(nq, 1))))
    chunk = -(-n // splits)
    chunk += -chunk % 4
    splits = -(-n // chunk)
    return {
        "slots": slots, "splits": splits, "chunk": chunk,
        "scratch_i": nq * (_BINS + _STATE + slots + splits), "scratch_f": nq * slots,
    }


def topk_select_plain(
    vals: torch.Tensor, k: int, ids: torch.Tensor | None = None, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """A stable descending sort of each row, cut at k: ties keep the lower
    position first, and -0 sorts as +0 (``+ 0.0`` turns it into +0 for the
    sort; the values come back as they were)."""
    v = vals.float()
    order = torch.sort(v + 0.0, dim=1, descending=True, stable=True).indices[:, :k]
    v = torch.gather(v, 1, order)
    out = torch.gather(ids, 1, order) if ids is not None else order + offset
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
    plan = select_plan(nq, n, k)
    out_vals = torch.empty((nq, k), device=device)
    out_ids = torch.empty((nq, k), dtype=torch.int32, device=device)
    if nq == 0:
        return out_vals, out_ids
    # one allocation: the int32 scratch, then the f32 candidate values
    scratch = torch.empty((plan["scratch_i"] + plan["scratch_f"],), dtype=torch.int32, device=device)
    lib = _build.library("topk_select")
    launch(
        "topk_select", lib.pw_topk_select, device,
        vals.data_ptr(), None if ids is None else ids.data_ptr(),
        out_vals.data_ptr(), out_ids.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * plan["scratch_i"],
        nq, n, k, plan["slots"], plan["splits"], plan["chunk"], offset,
    )
    topk_select.launches += lib.pw_topk_select_launches()
    return out_vals, out_ids


#: CUDA kernels launched in this process (six per call)
topk_select.launches = 0
