"""K12: the IVF cell scan (``csrc/ivf_scan.cu``), merged by K3's pass 2.

Replaces the gather -> score -> top-k of ``_search_jit`` -> ``block``,
``pathway_tpu/parallel/ivf_knn.py:318-339``.  Each query ``q [nq, d]``
f32 (already normalised for ``cos``) is scored against the rows of its
probed cells ``probe [nq, nprobe]`` (int32, from the centroid probe) in
``cells [nlist, cap, d]`` (bf16 or f32), the query rounded to the cells'
type first and the products summed in f32; slots with ``valid [nlist,
cap] == 0`` score ``NEG_INF``.  Returns ``(vals [nq, k] f32, flat [nq, k]
int32)``, best first, where ``flat = cell * cap + slot``; where fewer
than k slots are valid the rest come back as ``NEG_INF`` sentinels.

For CUDA tensors the wrapper launches the scan (any d whose rows lie 16
bytes apart: cells of another width are stored with their row pitch
rounded up, :mod:`~pathway_tpu_torch.kernels._pitch`, and scanned over the
whole pitch against zero-padded queries) and raises on anything else: up
to :data:`~pathway_tpu_torch.kernels.knn_topk.MAX_K` each block keeps its
best k and K3's merge passes reduce them
(:func:`~pathway_tpu_torch.kernels.knn_topk.merge_partials`); above it,
the scan writes every probed slot's score and K13
(:mod:`~pathway_tpu_torch.kernels.topk_select`) selects the k.  For CPU
tensors it runs :func:`ivf_scan_plain`.  Up to MAX_K, ties may come
back in another order than the JAX program's, which prefers the lower
probe rank; above it, K13 keeps that order.

The scan has two forms (:func:`scan_form`).  Below
:data:`CELL_MAJOR_MIN_QUERIES` queries it is query-major: a block per
(query, probed cell, share of its tiles), so a row that m queries probe is
read m times.  From there on, for k up to MAX_K, it is cell-major: four
blocks per cell, each every fourth granule of 64 slots, score every
(query, probe rank) pair that probes the cell, reading each live row of
the cell once a batch, and the last of the four to finish merges their
lists (``csrc/ivf_scan.cu``).  The cell-major form needs the cell's valid
flags 16 bytes apart (``cap`` a multiple of 4, at most 65,536) and its
shared memory within the card's 227 KB: the library's plan
(``pw_ivf_scan_cells_plan``) says whether it takes the arguments, and
sizes its scratch; where it does not, the query-major form runs.
"""

from __future__ import annotations

import ctypes

import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.kernels._pitch import widen
from pathway_tpu_torch.kernels.knn_topk import MAX_K, merge_partials
from pathway_tpu_torch.kernels.topk_select import topk_select
from pathway_tpu_torch.ops.topk import NEG_INF

__all__ = ["ivf_scan", "ivf_scan_plain", "check_ivf_scan", "scan_form", "CELL_MAJOR_MIN_QUERIES"]

_TILE = 256  # slots per tile (csrc/ivf_scan.cu kTile)
#: blocks a scan aims for: with fewer (query, cell) pairs than this, each
#: probed cell's tiles are shared out over several blocks, so one query's
#: few live tiles spread over the card's 132 SMs
_TARGET_BLOCKS = 2048
#: from this many queries on, a search with k <= MAX_K scans cell-major
#: (each probed row read once a batch); below it, query-major.  Set from
#: chip_smoke.py phase 6's table of both forms by nq over the 1M-row IVF
#: at its defaults on an H100 (PERF.md)
CELL_MAJOR_MIN_QUERIES = 8


def scan_form(nq: int) -> str:
    """``"cell"`` (cell-major) or ``"query"`` (query-major): the form a
    search of ``nq`` queries with k <= MAX_K takes."""
    return "cell" if nq >= CELL_MAJOR_MIN_QUERIES else "query"


def ivf_scan_plain(
    q: torch.Tensor, probe: torch.Tensor, cells: torch.Tensor, valid: torch.Tensor,
    k: int, query_block: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX program's gather -> einsum -> masked top-k -> flat ids, over
    ``query_block`` queries at a time as its ``lax.map`` goes, so the
    gathered ``[query_block, nprobe, cap, d]`` block bounds the memory."""
    cap = cells.shape[1]
    slot = torch.arange(cap, device=cells.device)
    vals, ids = [], []
    for lo in range(0, q.shape[0], query_block):
        pb = probe[lo : lo + query_block].long()
        qb = q[lo : lo + query_block].to(cells.dtype).float()
        s = torch.einsum("qd,qpcd->qpc", qb, cells[pb].float())
        s = torch.where(valid[pb].bool(), s, torch.full_like(s, NEG_INF))
        v, pos = torch.topk(s.reshape(len(pb), -1), k, dim=1)
        flat = (pb[:, :, None] * cap + slot).reshape(len(pb), -1)
        vals.append(v)
        ids.append(torch.gather(flat, 1, pos).to(torch.int32))
    if not vals:
        return torch.empty((0, k), device=q.device), torch.empty((0, k), dtype=torch.int32, device=q.device)
    return torch.cat(vals), torch.cat(ids)


def ivf_scan(
    q: torch.Tensor, probe: torch.Tensor, cells: torch.Tensor, valid: torch.Tensor,
    k: int, query_block: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (score, flat id) per query over its probed cells.
    ``query_block`` is the plain version's block of queries (CPU tensors)."""
    if cells.dim() != 3 or probe.dim() != 2 or q.dim() != 2 or probe.shape[0] != q.shape[0]:
        raise ValueError(f"ivf_scan: cells {tuple(cells.shape)}, probe {tuple(probe.shape)}, q {tuple(q.shape)}")
    nlist, cap, d = cells.shape
    nq, nprobe = probe.shape
    if not 1 <= k <= nprobe * cap:
        raise ValueError(f"ivf_scan: k={k} outside 1..{nprobe * cap} (nprobe * cap)")
    if q.device.type == "cpu":
        return ivf_scan_plain(q, probe, cells, valid, k, query_block)
    check_ivf_scan(q, probe, cells, valid)
    wide = widen(cells, 4 if cells.dtype == torch.float32 else 8, "ivf_scan")
    device = check_cuda("ivf_scan", q=q, probe=probe, cells=wide, valid=valid)
    if nq == 0:
        return torch.empty((0, k), device=device), torch.empty((0, k), dtype=torch.int32, device=device)
    qr = q.to(cells.dtype).float() if cells.dtype != torch.float32 else q
    if wide.shape[2] > d:  # zero columns up to the cells' pitch
        qr = torch.nn.functional.pad(qr, (0, wide.shape[2] - d))
    return _launch(qr.contiguous(), probe, wide, valid, k, scan_form(nq) == "cell", device)


def _launch(qr, probe, wide, valid, k, cell_major: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan in the form asked for, where it takes these arguments (else
    the query-major form), then its merge or K13.  ``qr``: the queries
    rounded to the cells' type, zero-padded to the pitch; ``wide``: the
    cells over their whole pitch."""
    nlist, cap, d = wide.shape
    nq, nprobe = probe.shape
    bf16 = int(wide.dtype == torch.bfloat16)
    lib = _build.library("ivf_scan")
    scratch = (ctypes.c_longlong * 2)()  # list entries, tickets
    if (
        cell_major and probe.data_ptr() % 16 == 0 and valid.data_ptr() % 16 == 0
        and lib.pw_ivf_scan_cells_plan(d, bf16, k, nlist, cap, nq * nprobe, scratch)
    ):
        qc = qr.to(wide.dtype)  # exact: qr is already rounded to the cells' type
        lists = torch.empty((2, scratch[0]), dtype=torch.float32, device=device)
        tickets = torch.zeros((scratch[1],), dtype=torch.int32, device=device)
        vals = torch.empty((nq, nprobe * k), device=device)
        idx = torch.empty((nq, nprobe * k), dtype=torch.int32, device=device)
        launch(
            "ivf_scan", lib.pw_ivf_scan_cells, device,
            qc.data_ptr(), probe.data_ptr(), wide.data_ptr(), valid.data_ptr(), lists[0].data_ptr(),
            lists[1].data_ptr(), tickets.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            nq, nprobe, d, nlist, cap, k, bf16,
        )
        ivf_scan.launches += 1
        return merge_partials(vals, idx, k)
    splits = min(-(-cap // _TILE), max(1, _TARGET_BLOCKS // (nq * nprobe)))
    kept = 0 if k > MAX_K else k  # 0: the score-only scan, for K13
    width = nprobe * cap if kept == 0 else nprobe * splits * k
    vals = torch.empty((nq, width), device=device)
    idx = torch.empty((nq, width), dtype=torch.int32, device=device)
    launch(
        "ivf_scan", lib.pw_ivf_scan, device,
        qr.data_ptr(), probe.data_ptr(), wide.data_ptr(), valid.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), nq, nprobe, d, nlist, cap, splits, kept, bf16,
    )
    ivf_scan.launches += 1
    if kept == 0:
        return topk_select(vals, k, idx)
    return merge_partials(vals, idx, k)


def check_ivf_scan(q: torch.Tensor, probe: torch.Tensor, cells: torch.Tensor, valid: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the scan takes these arguments; reads
    shapes, types and strides only, on any device."""
    nlist, cap, d = cells.shape
    nq = probe.shape[0]
    if cells.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ivf_scan: cells must be f32 or bf16, got {cells.dtype}")
    widen(cells, 4 if cells.dtype == torch.float32 else 8, "ivf_scan")
    if cells.data_ptr() % 16:
        raise ValueError("ivf_scan: cells must be 16-byte aligned")
    if q.dtype != torch.float32 or q.shape[1] != d:
        raise ValueError(f"ivf_scan: q must be f32 [nq, {d}]")
    if probe.dtype != torch.int32:
        raise ValueError("ivf_scan: probe must be int32 [nq, nprobe]")
    if valid.dtype != torch.float32 or valid.shape != (nlist, cap):
        raise ValueError(f"ivf_scan: valid must be f32 [{nlist}, {cap}]")
    if nlist * cap >= 2**31 or nq > 65535:
        raise ValueError(f"ivf_scan: {nlist} x {cap} slots or {nq} queries past the kernel's int32 ids / grid")


#: launches of the scan kernel in this process (the merge passes count
#: on ``knn_topk.launches``)
ivf_scan.launches = 0
