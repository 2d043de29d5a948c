"""K3: fused retrieval scores + valid mask + top-k (``csrc/knn_topk.cu``).

Replaces ``_search_jit`` -> ``run``, ``pathway_tpu/parallel/sharded_knn.py:
336-341``.  ``queries [nq, d]`` f32 (already normalized for ``cos``) are
scored against ``slab [capacity, d]`` (f32 or bf16): the inner product
for ``dot``, the negated clamped squared distance for ``l2sq``.  Slots
with ``valid == 0`` score ``NEG_INF``.  Returns ``(values [nq, k] f32,
slots [nq, k] int32)``, best first; where fewer than k slots are valid
the rest come back as ``NEG_INF`` sentinels.

As in the JAX program, queries are rounded to the slab's type before
scoring (a bf16 slab scores bf16 queries, in f32).  ``offset`` is added
to every slot id: a shard's first global slot, so that a shard's search
returns global slots (the mesh search's ``li + axis_index * shard_rows``,
``sharded_knn.py:358``).

For CUDA tensors the wrapper launches the kernels (any d whose rows lie
16 bytes apart: a slab of another width is stored with its row pitch
rounded up, :mod:`~pathway_tpu_torch.kernels._pitch`, and the wrapper
scores the whole pitch against zero-padded queries; what they take is
:func:`check_knn_topk`'s) and raises on anything else: up to
:data:`MAX_K`, pass 1 keeps each tile's best k and the merge passes
reduce them; above it, pass 1 writes every score and K13
(:mod:`~pathway_tpu_torch.kernels.topk_select`) selects the k.  For
:data:`TILED_MIN_QUERIES` queries and more over an f32 slab, pass 1 runs
the product on the tensor cores in 3xTF32 after a split of the queries
(:func:`tiled_groups` says how they are grouped).  For CPU tensors it
runs :func:`knn_topk_plain`.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.kernels._pitch import widen
from pathway_tpu_torch.kernels.topk_select import topk_select, topk_select_plain
from pathway_tpu_torch.ops.distances import dot_scores, l2sq_distances
from pathway_tpu_torch.ops.topk import masked_top_k

__all__ = [
    "knn_topk", "knn_topk_plain", "check_knn_topk", "merge_partials", "merge_passes", "tiled_groups", "MAX_K",
    "METRICS",
]

#: largest k that pass 1 selects per 256-row tile and the merge passes
#: reduce; a larger k goes through the score-only pass and K13
MAX_K = 128
METRICS = ("dot", "l2sq")
_ROWS = 256  # slab rows per pass-1 block (csrc/knn_topk.cu kRows)
_GROUP = 32  # queries per pass-1 block (kMaxGroup)
_GROUP_DIMS = 32 * 1024  # queries x dims the row pass keeps in shared memory
_SEGMENT = 1024  # candidates per pass-2 block
#: from this many queries on, pass 1 scores tiles of 256 rows as a matrix
#: product (3xTF32 on the tensor cores for an f32 slab); below it, each
#: warp streams rows.  Set from chip_smoke.py's table of both paths by nq
#: over 1,048,576 x 768 f32 rows on an H100 (PERF.md): the tiled pass is
#: slower up to nq=4 and faster from 8 on
TILED_MIN_QUERIES = 8
#: the query widths of the tensor-core pass: a group of queries is one
#: wgmma's N, nq rounded up to one of these; above the last, groups of it
TC_WIDTHS = (8, 16, 32, 64)


def tiled_groups(nq: int) -> tuple[int, int]:
    """(N, groups) of the tensor-core pass over an f32 slab for ``nq``
    queries: each group of N queries reads the slab once."""
    if nq < 1:
        raise ValueError(f"knn_topk: nq={nq}")
    width = next((w for w in TC_WIDTHS if nq <= w), TC_WIDTHS[-1])
    return width, -(-nq // width)


def check_knn_topk(queries: torch.Tensor, slab: torch.Tensor, valid: torch.Tensor, offset: int = 0) -> None:
    """Raise ``ValueError`` unless the kernels take these arguments; reads
    shapes, types and alignment only, on any device."""
    cap, d = slab.shape
    if slab.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"knn_topk: slab must be f32 or bf16, got {slab.dtype}")
    widen(slab, 4 if slab.dtype == torch.float32 else 8, "knn_topk")
    if queries.dtype != torch.float32 or queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"knn_topk: queries must be f32 [nq, {d}]")
    if valid.dtype != torch.float32 or valid.shape != (cap,):
        raise ValueError("knn_topk: valid must be f32 [capacity]")
    if cap + offset >= 2**31:
        raise ValueError(f"knn_topk: slots up to {cap + offset} past the kernel's int32 ids")
    if slab.data_ptr() % 16 or queries.data_ptr() % 16:
        # the tensor-core pass reads slab rows by TMA, and queries by 16 bytes
        raise ValueError("knn_topk: slab and queries must be 16-byte aligned")


def knn_topk_plain(
    queries: torch.Tensor, slab: torch.Tensor, valid: torch.Tensor, k: int, metric: str,
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    q = queries.to(slab.dtype)
    scores = -l2sq_distances(q, slab) if metric == "l2sq" else dot_scores(q, slab)
    vals, idx = masked_top_k(scores, valid, k)
    return vals, (idx + offset).to(torch.int32)


def knn_topk(
    queries: torch.Tensor, slab: torch.Tensor, valid: torch.Tensor, k: int, metric: str,
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k slots (plus ``offset``) per query over the valid rows of ``slab``."""
    if metric not in METRICS:
        raise ValueError(f"knn_topk: metric {metric!r} not in {METRICS}")
    cap, d = slab.shape
    if not 1 <= k <= cap:
        raise ValueError(f"knn_topk: k={k} outside 1..{cap} (slab rows)")
    if queries.device.type == "cpu":
        return knn_topk_plain(queries, slab, valid, k, metric, offset)
    check_knn_topk(queries, slab, valid, offset)
    wide = widen(slab, 4 if slab.dtype == torch.float32 else 8, "knn_topk")
    device = check_cuda("knn_topk", queries=queries, slab=wide, valid=valid)
    nq = queries.shape[0]
    if nq == 0:
        return (torch.empty((0, k), device=device), torch.empty((0, k), dtype=torch.int32, device=device))
    q = queries.to(slab.dtype).float() if slab.dtype != torch.float32 else queries
    if wide.shape[1] > d:  # zero columns up to the slab's pitch
        q = F.pad(q, (0, wide.shape[1] - d))
    return _launch(q, wide, valid, k, metric, nq >= TILED_MIN_QUERIES, offset)


def _launch(
    q: torch.Tensor, slab: torch.Tensor, valid: torch.Tensor, k: int, metric: str, tiled: bool,
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 (row-streaming or tiled) and the merge passes, or for k >
    MAX_K the score-only pass 1 and K13, on checked inputs; each kernel
    launched adds one to its wrapper's ``launches`` (the tiled pass over an
    f32 slab is two: the split of the queries, then the pass).  ``tiled``
    is chosen by :func:`knn_topk`; timing both passes on the card
    (``chip_smoke.py``) is what set :data:`TILED_MIN_QUERIES`."""
    cap, d = slab.shape
    nq = q.shape[0]
    device = q.device
    lib = _build.library("knn_topk")
    bf16 = int(slab.dtype == torch.bfloat16)
    l2sq = int(metric == "l2sq")

    tiles = -(-cap // _ROWS)
    # the tensor-core pass: one block an SM, each keeping a running list of
    # the best k per query over the tiles it walks
    tc = tiled and not bf16
    blocks = min(tiles, torch.cuda.get_device_properties(device).multi_processor_count) if tc else 0
    if k > MAX_K:
        kk = 0  # score-only: every slot's masked score, for K13
        vals = torch.empty((nq, cap), device=device)
        idx = vals  # unused by the score-only pass
    else:
        kk = min(k, _ROWS)
        lists = blocks if tc else tiles
        vals = torch.empty((nq, lists * kk), device=device)
        idx = torch.empty((nq, lists * kk), dtype=torch.int32, device=device)
    ptrs = (q.data_ptr(), slab.data_ptr(), valid.data_ptr(), vals.data_ptr(), idx.data_ptr())
    if tiled:
        scratch = None
        if tc:  # the queries' TF32 hi and lo parts and squared norms
            width, groups = tiled_groups(nq)
            rows = width * groups
            scratch = torch.empty((2 * rows * d + rows,), device=device)
            knn_topk.launches += 1
        launch(
            "knn_topk", lib.pw_knn_partial_tiled, device, *ptrs[:3],
            None if scratch is None else scratch.data_ptr(), *ptrs[3:], nq, d, cap, bf16, kk, l2sq, offset,
            blocks,
        )
    else:
        group = min(nq, _GROUP, max(1, _GROUP_DIMS // d))
        launch(
            "knn_topk", lib.pw_knn_partial, device,
            *ptrs, nq, d, cap, bf16, group, kk, l2sq, offset,
        )
    knn_topk.launches += 1
    if k > MAX_K:
        return topk_select(vals, k, offset=offset)
    return merge_partials(vals, idx, k)


def _segment(n_in: int) -> int:
    """The candidates a merge block sorts, for ``n_in`` a query."""
    return min(_SEGMENT, 1 << max(1, (n_in - 1).bit_length()))


def merge_passes(n_in: int, k: int) -> int:
    """The merge launches :func:`merge_partials` makes to reduce ``n_in``
    presorted candidates a query to k <= MAX_K."""
    passes = 0
    while n_in > k:
        n_in = -(-n_in // _segment(n_in)) * k
        passes += 1
    return passes


def merge_partials(
    vals: torch.Tensor, idx: torch.Tensor, k: int, *, presorted: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce each row's candidates ``(vals [nq, n] f32, idx [nq, n]
    int32)``, n >= k, to its best k, best first.  On the card, for k <=
    MAX_K, K3's pass 2: merge passes over segments of up to 1,024 entries,
    each one launch of ``pw_knn_merge`` that adds one to
    ``knn_topk.launches`` (``ivf_scan`` merges its partial lists here
    too); ``presorted=False`` says the candidates are not already k best
    ones sorted, so one pass runs even when n == k.  Above MAX_K, K13
    (``topk_select``).  On the CPU, its plain version."""
    nq, n_in = vals.shape
    if vals.device.type == "cpu":
        return topk_select_plain(vals, k, idx)
    if k > MAX_K:
        return topk_select(vals, k, idx)
    device = vals.device
    lib = _build.library("knn_topk")
    while n_in > k or not presorted:
        presorted = True
        seg = _segment(n_in)
        segs = -(-n_in // seg)
        out_vals = torch.empty((nq, segs * k), device=device)
        out_idx = torch.empty((nq, segs * k), dtype=torch.int32, device=device)
        launch(
            "knn_topk", lib.pw_knn_merge, device,
            vals.data_ptr(), idx.data_ptr(), out_vals.data_ptr(), out_idx.data_ptr(),
            nq, n_in, seg, k,
        )
        knn_topk.launches += 1
        vals, idx, n_in = out_vals, out_idx, segs * k
    return vals, idx


#: CUDA kernels launched in this process: pass 1 (the tiled pass over an
#: f32 slab with the split of its queries: two) and each merge pass count
#: one each (three per call over a 1,048,576-row slab at k=10 and one
#: query; at 32, the split, the pass and two merges of its 132 lists)
knn_topk.launches = 0
