#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``pathway_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit, torch/CUDA versions,
   and the build of every kernel from ``pathway_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the tolerance stated beside each check, and timed
   beside the plain version and the one PyTorch call that computes the
   same function;
3. the live-RAG main path at BGE-base full width (768 hidden, 12 layers,
   12 heads, MLP 3072, bf16, seeded random weights): a 1,048,576-slot
   cosine index bulk-filled with seeded random vectors, ~8k synthetic
   documents embedded and indexed on the device, a few deleted, and
   queries answered at nq=1 and nq=32; indexed documents re-embedded in
   the same batch must come back as their own top-1 with cosine >= 0.999,
   and the top-k must match a plain matmul + top-k over the same slab.
   Every kernel's launch count must rise during this phase.

The second-to-last line of output is a JSON object with one entry per
kernel; the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
HIDDEN = 768
CAPACITY = 1 << 20  # one million documents, the README's KNN scale
N_DOCS = 8192
DOC_BATCH = 256  # encoder rows per chunk on the main path
N_REMOVED = 16
K = 10

# stated tolerances
ATTN_ATOL = ATTN_RTOL = 2e-2  # bf16 output (8 mantissa bits); plain rounds logits to bf16, K1 keeps f32
SCATTER_ATOL = 1e-6  # f32 norm summed in another order: ~1 ulp of a unit-norm row
TOPK_ATOL = 1e-5  # f32 dot of unit rows over 768 dims, summed in another order
SELF_COS = 0.999

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 and f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms: the kernel time the profiler saw
    over ``iters`` calls.  For launches too small to hide the host's launch
    cost, where CUDA events measure the launch rate instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(
        getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    )
    return total / 1e3 / iters


def compare_topk(kv, ki, pv, pi, tol: float) -> float:
    """Kernel (kv, ki) against plain (pv, pi) top-k, both best first:
    values within ``tol``; every slot the plain version ranks clear of its
    k-th value by more than ``tol`` (away from near-ties) is in the
    kernel's list.  Returns the largest value difference."""
    err = (kv - pv).abs().max().item()
    if not err <= tol:
        fail(f"top-k values differ by {err} > {tol}")
    kth = pv[:, -1:]
    for r in range(pv.shape[0]):
        sure = set(pi[r][pv[r] > kth[r] + tol].tolist())
        missing = sure - set(ki[r].tolist())
        if missing:
            fail(f"top-k row {r}: kernel misses slots {sorted(missing)[:5]}")
    return err


def phase_kernels(torch, dev) -> dict:
    """Phase 2: each kernel against its plain version; returns the
    measurements per kernel."""
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import (
        attention,
        attention_plain,
        MAX_K,
        knn_topk,
        knn_topk_plain,
        slab_clear,
        slab_clear_plain,
        slab_scatter,
        slab_scatter_plain,
    )
    from pathway_tpu_torch.kernels.knn_topk import TILED_MIN_QUERIES
    from pathway_tpu_torch.kernels.knn_topk import _launch as knn_launch
    from pathway_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    out: dict = {}

    # ---- K1 attention.  The main path's shape: chunks of DOC_BATCH documents
    # of 64-256 tokens, padded to the batch's power-of-two width (256).
    # Also B=32 at L in {128, 512}, the other main-path widths, and short/narrow shapes.
    def attn_inputs(B, L, H, D, min_len=1):
        q, k, v = (torch.randn((B, L, H, D), generator=g, device=dev).to(bf16) for _ in range(3))
        lens = torch.randint(min_len, L + 1, (B,), generator=g, device=dev)
        lens[0] = L
        mask = (torch.arange(L, device=dev)[None] < lens[:, None]).to(torch.uint8)
        return q, k, v, mask

    attn_err = 0.0
    for B, L, H, D in (
        (DOC_BATCH, 256, 12, 64), (DOC_BATCH, 128, 12, 64), (DOC_BATCH, 64, 12, 64),
        (32, 128, 12, 64), (32, 512, 12, 64), (4, 16, 12, 64), (4, 100, 12, 32),
    ):
        q, k, v, mask = attn_inputs(B, L, H, D)
        got = attention(q, k, v, mask).float()
        ref = attention_plain(q, k, v, mask).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        if not torch.isfinite(got).all() or (err > ATTN_ATOL + ATTN_RTOL * ref.abs()).any():
            fail(f"attention B={B} L={L} D={D}: max err {err.max().item()}")
        attn_err = max(attn_err, err.max().item())
        log(f"K1 attention B={B} L={L} H={H} D={D}: max_abs_err {err.max().item():.3e}")
        del q, k, v, mask, got, ref, err

    def attn_timing(B, L, H, D, min_len):
        """Times at one shape; the bound counts the keys the masks keep:
        every query row attends over its batch row's present keys only."""
        q, k, v, mask = attn_inputs(B, L, H, D, min_len)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask.bool()[:, None, None, :]
        keys = int(mask.sum())
        nbytes = 2 * B * L * H * D * 2 + 2 * keys * H * D * 2 + B * L
        b_ms, b_by = bound(nbytes, 4 * H * D * L * keys, PEAK_BF16)
        return {
            "shape": f"B={B} L={L} H={H} D={D} bf16, {keys} of {B * L} keys present",
            "ms": time_ms(torch, lambda: attention(q, k, v, mask), 20),
            "plain_ms": time_ms(torch, lambda: attention_plain(q, k, v, mask), 5),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), 20
            ),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }

    out["attention"] = {**attn_timing(DOC_BATCH, 256, 12, 64, 64), "max_abs_err": attn_err}
    out["_attention_b32_l512"] = attn_timing(32, 512, 12, 64, 1)
    log(f"K1 attention timings: {json.dumps(out['attention'])} {json.dumps(out['_attention_b32_l512'])}")

    # ---- K2 slab scatter / clear: 256 rows (200 live + 56 pads) into [1M, 768] f32
    slab = torch.randn((CAPACITY, HIDDEN), generator=g, device=dev)
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    n_rows, n_live = 256, 200
    live = torch.randperm(CAPACITY, generator=g, device=dev)[:n_live]
    slots = torch.full((n_rows,), CAPACITY, dtype=torch.int32, device=dev)
    slots[:n_live] = live.int()
    vals = torch.randn((n_rows, HIDDEN), generator=g, device=dev) * 3.0
    slab_k, valid_k = slab.clone(), valid.clone()
    slab_p, valid_p = slab.clone(), valid.clone()
    slab_scatter(slab_k, valid_k, slots, vals, True)
    slab_scatter_plain(slab_p, valid_p, slots, vals, True)
    scatter_err = (slab_k - slab_p).abs().max().item()
    if scatter_err > SCATTER_ATOL or not torch.equal(valid_k, valid_p):
        fail(f"slab_scatter: max err {scatter_err}")
    slab_clear(valid_k, slots)
    slab_clear_plain(valid_p, slots)
    if not torch.equal(valid_k, valid_p):
        fail("slab_clear differs from its plain version")
    # bf16 slab, bf16 rows, no normalise
    sb_k = torch.zeros((4096, HIDDEN), dtype=bf16, device=dev)
    vb_k = torch.zeros((4096,), device=dev)
    sb_p, vb_p = sb_k.clone(), vb_k.clone()
    bslots = torch.randperm(4096, generator=g, device=dev)[:n_rows].int()
    bslots[-8:] = 4096
    slab_scatter(sb_k, vb_k, bslots, vals.to(bf16), False)
    slab_scatter_plain(sb_p, vb_p, bslots, vals.to(bf16), False)
    if not (torch.equal(sb_k, sb_p) and torch.equal(vb_k, vb_p)):
        fail("slab_scatter (bf16) differs from its plain version")
    log(f"K2 slab_scatter/slab_clear: max_abs_err {scatter_err:.3e}")
    kept = live.long()
    # what the function needs: every slot read; the live rows read, written
    # and their valid flags set (pad rows are dropped unread)
    nbytes = n_rows * 4 + n_live * HIDDEN * 4 + n_live * (HIDDEN * 4 + 4)
    b_ms, b_by = bound(nbytes, 3 * n_live * HIDDEN, PEAK_F32)
    out["slab_scatter"] = {
        "shape": f"b={n_rows} ({n_live} live) into [{CAPACITY},{HIDDEN}] f32, normalise",
        "max_abs_err": scatter_err,
        "ms": time_ms(torch, lambda: slab_scatter(slab_k, valid_k, slots, vals, True), 200),
        "plain_ms": time_ms(torch, lambda: slab_scatter_plain(slab_p, valid_p, slots, vals, True), 50),
        "library_ms": time_ms(torch, lambda: slab_k.index_copy_(0, kept, vals[:n_live]), 200),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    b_ms, b_by = bound(n_rows * 4 + n_live * 4, 0, PEAK_F32)
    zeros = torch.zeros((n_live,), device=dev)
    out["slab_clear"] = {
        "shape": f"b={n_rows} ({n_live} live) of [{CAPACITY}] valid flags",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: slab_clear(valid_k, slots), 200),
        "plain_ms": time_ms(torch, lambda: slab_clear_plain(valid_p, slots), 50),
        "library_ms": time_ms(torch, lambda: valid_k.index_copy_(0, kept, zeros), 200),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    for name, kern, plain, lib in (
        ("slab_scatter", lambda: slab_scatter(slab_k, valid_k, slots, vals, True),
         lambda: slab_scatter_plain(slab_p, valid_p, slots, vals, True),
         lambda: slab_k.index_copy_(0, kept, vals[:n_live])),
        ("slab_clear", lambda: slab_clear(valid_k, slots), lambda: slab_clear_plain(valid_p, slots),
         lambda: valid_k.index_copy_(0, kept, zeros)),
    ):
        out[name]["device_ms"] = {
            "kernel": device_ms(torch, kern), "plain": device_ms(torch, plain),
            "library": device_ms(torch, lib),
        }
        log(f"K2 {name} device time (profiler): {json.dumps(out[name]['device_ms'])}")
    del slab_p, valid_p, sb_k, sb_p

    # ---- K3 knn_topk over the same slab, unit rows again, ~10% invalid: nq in {1, 32, 64}, k=10
    slab = slab_k
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    topk_err = 0.0
    timings = {}
    for nq in (1, 32, 64):
        qn = torch.randn((nq, HIDDEN), generator=g, device=dev)
        qn /= qn.norm(dim=1, keepdim=True)
        kv, ki = knn_topk(qn, slab, valid, K, "dot")
        pv, pi = knn_topk_plain(qn, slab, valid, K, "dot")
        torch.cuda.synchronize()
        topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
        if not bool((valid[ki.long()] == 1).all()):
            fail(f"knn_topk nq={nq} returned an invalid slot")
        # what the function needs: the valid rows (an invalid row's contents
        # never reach the answer), every valid flag, the queries, the output
        n_valid = int(valid.sum())
        nbytes = n_valid * HIDDEN * 4 + CAPACITY * 4 + nq * HIDDEN * 4 + nq * K * 8
        b_ms, b_by = bound(nbytes, 2 * nq * n_valid * HIDDEN, PEAK_F32)
        timings[nq] = {
            "shape": f"nq={nq} k={K} over [{CAPACITY},{HIDDEN}] f32, {n_valid} rows valid",
            "ms": time_ms(torch, lambda: knn_topk(qn, slab, valid, K, "dot"), 10),
            "plain_ms": time_ms(torch, lambda: knn_topk_plain(qn, slab, valid, K, "dot"), 5),
            "library_ms": time_ms(torch, lambda: torch.topk(torch.matmul(qn, slab.T), K), 5),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        log(f"K3 knn_topk nq={nq}: {json.dumps(timings[nq])}")
    # fewer live rows than k: the rest must come back as NEG_INF sentinels
    few = torch.zeros((CAPACITY,), device=dev)
    few[torch.randperm(CAPACITY, generator=g, device=dev)[:5]] = 1.0
    for qs in (qn[:2], qn):
        kv, ki = knn_topk(qs, slab, few, K, "dot")
        pv, pi = knn_topk_plain(qs, slab, few, K, "dot")
        topk_err = max(topk_err, compare_topk(kv[:, :5], ki[:, :5], pv[:, :5], pi[:, :5], TOPK_ATOL))
        if not bool((kv[:, 5:] <= NEG_INF / 2).all()):
            fail("knn_topk: missing NEG_INF sentinels when k > live rows")
    # both pass-1 paths: bf16 slab, l2sq, the largest k
    small = slab[:65536].to(bf16)
    for qs in (qn[:2], qn):
        for s_, metric, k in ((small, "dot", 128), (small, "l2sq", 10), (slab[:65536], "l2sq", 128)):
            kv, ki = knn_topk(qs, s_, valid[:65536], k, metric)
            pv, pi = knn_topk_plain(qs, s_, valid[:65536], k, metric)
            topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
    # the largest k, off the main path: every tile's best 128 by arg-max rounds
    k128 = {}
    for nq in (1, 32):
        qs = qn[:nq]
        k128[nq] = time_ms(torch, lambda: knn_topk(qs, slab, valid, MAX_K, "dot"), 5)
    log(f"K3 knn_topk k={MAX_K} ms by nq: {json.dumps(k128)}")
    # the two pass-1 paths against each other by nq: what sets TILED_MIN_QUERIES
    paths = {}
    for nq in (1, 2, 4, 8, 16, 32, 64):
        qs = torch.randn((nq, HIDDEN), generator=g, device=dev)
        qs /= qs.norm(dim=1, keepdim=True)
        pv, pi = knn_topk_plain(qs, slab, valid, K, "dot")
        row = {}
        for tiled in (False, True):
            kv, ki = knn_launch(qs, slab, valid, K, "dot", tiled)
            topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
            row["tiled_ms" if tiled else "rows_ms"] = time_ms(
                torch, lambda: knn_launch(qs, slab, valid, K, "dot", tiled), 5
            )
        paths[nq] = row
    log(f"K3 pass-1 paths by nq (TILED_MIN_QUERIES={TILED_MIN_QUERIES}): {json.dumps(paths)}")
    log(f"K3 knn_topk: max_abs_err {topk_err:.3e}")
    out["knn_topk"] = {**timings[32], "max_abs_err": topk_err}
    out["_knn_topk_by_nq"] = timings
    out["_knn_paths"] = paths
    out["_knn_k128"] = k128
    return out


def synthetic_docs(np, n: int, seed: int) -> list[str]:
    """``n`` documents of 64-256 tokens (with [CLS]/[SEP]) over a 50k-word
    synthetic vocabulary, from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(62, 255, n)
    words = rng.integers(0, 50_000, int(lens.sum()))
    docs, pos = [], 0
    for ln in lens:
        docs.append(" ".join(f"w{w}" for w in words[pos : pos + ln]))
        pos += ln
    return docs


def profile_encode(torch, embedder, index, keys, docs) -> dict:
    """Device time by kernel over one ``encode_into`` call, and the share of
    the call's wall time the device was busy (one stream, so kernels do
    not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        embedder.encoder.encode_into(index, keys, docs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # kernel rows only: operator rows carry their kernels' time too
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {
        "docs": len(docs),
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "top": [{"name": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:15]],
    }


def phase_slice(torch, dev) -> dict:
    """Phase 3: the main path at BGE-base full width."""
    import numpy as np

    from pathway_tpu_torch import ShardedKnnIndex, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.internals import device_counters
    from pathway_tpu_torch.ops.distances import normalize

    res: dict = {}
    kernels.reset_launch_counts()
    device_counters.reset_for_tests()
    torch.cuda.reset_peak_memory_stats()

    index = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    n_bulk = CAPACITY - N_DOCS - 1024
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    chunk = 65536
    for start in range(0, n_bulk, chunk):
        n = min(chunk, n_bulk - start)
        vecs = rng.standard_normal((n, HIDDEN), dtype=np.float32)
        index.add_batch(range(start, start + n), vecs)
    torch.cuda.synchronize()
    res["bulk_rows_per_s"] = n_bulk / (time.perf_counter() - t0)
    log(f"bulk fill: {n_bulk} rows through add_batch at {res['bulk_rows_per_s']:.0f} rows/s")

    embedder = TorchEncoderEmbedder("bge-base", max_batch_size=DOC_BATCH, seed=SEED, device=dev)
    if embedder.get_embedding_dimension() != HIDDEN:
        fail("embedder width is not 768")
    docs = synthetic_docs(np, N_DOCS, SEED)
    keys = [f"doc-{i}" for i in range(N_DOCS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = embedder.encoder.encode_into(index, keys, docs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["embed_docs_per_s"] = n / dt
    res["encoder_batches"] = -(-N_DOCS // DOC_BATCH)
    log(f"encode_into: {n} docs in {dt:.3f} s = {res['embed_docs_per_s']:.1f} docs/s")
    if len(index) != n_bulk + N_DOCS:
        fail(f"index holds {len(index)} keys, expected {n_bulk + N_DOCS}")
    index.remove(keys[-N_REMOVED:])

    # queries: the first chunk's documents, re-embedded in the same batch
    q_all = embedder.encoder.encode(docs[:DOC_BATCH])
    if q_all.shape != (DOC_BATCH, HIDDEN) or not np.isfinite(q_all).all():
        fail(f"query embeddings: shape {q_all.shape} or non-finite values")
    lat: dict = {}
    for nq, reps in ((1, 50), (32, 20)):
        times = []
        for r in range(reps):
            lo = (r * nq) % (DOC_BATCH - nq + 1)
            qs = q_all[lo : lo + nq]
            t0 = time.perf_counter()
            rows = index.search(qs, K)
            times.append((time.perf_counter() - t0) * 1e3)
            margins = []
            for i, row in enumerate(rows):
                if len(row) != K:
                    fail(f"search nq={nq}: {len(row)} results, expected {K}")
                key, score = row[0]
                if key != keys[lo + i] or score < SELF_COS:
                    fail(f"search nq={nq}: query doc-{lo + i} came back as {key} ({score})")
                margins.append(score - row[1][1])
        lat[nq] = {
            "p50_ms": float(np.percentile(times, 50)),
            "p99_ms": float(np.percentile(times, 99)),
            "min_top1_margin": float(min(margins)),
        }
        log(f"search nq={nq}: {json.dumps(lat[nq])}")
    res["search"] = lat
    res["launches"] = kernels.launch_counts()
    res["transfers"] = device_counters.snapshot()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the index's answers against a plain matmul + top-k over its own slab
    from pathway_tpu_torch.kernels import knn_topk_plain

    qs = q_all[:32]
    rows = index.search(qs, K)
    q = normalize(torch.from_numpy(qs).to(dev))
    pv, pi = knn_topk_plain(q, index._vectors, index._valid, K, "dot")
    for r, row in enumerate(rows):
        got = [s for s, _ in row]
        sure = [index._key_of[int(s)] for s, v in zip(pi[r].tolist(), pv[r].tolist())
                if v > pv[r, -1].item() + TOPK_ATOL]
        if any(key not in got for key in sure):
            fail(f"search row {r} disagrees with the plain top-k over the slab")
        err = max(abs(a - b) for (_, a), b in zip(row, pv[r].tolist()))
        if err > TOPK_ATOL:
            fail(f"search row {r}: scores differ from plain by {err}")

    # host tokenizer alone, and a device profile of one more pass over
    # the first 1024 documents (upserts of the same keys)
    tok = embedder.encoder.tokenizer
    t0 = time.perf_counter()
    n_tok, widths = 0, set()
    for i in range(0, N_DOCS, DOC_BATCH):
        ids, mask = tok.encode_batch(docs[i : i + DOC_BATCH])[:2]
        n_tok += int(mask.sum())
        widths.add(ids.shape[1])
    res["tokenize_tokens_per_s"] = n_tok / (time.perf_counter() - t0)
    res["attention_widths"] = sorted(widths)
    if not widths <= {64, 128, 256}:
        fail(f"encoder chunk widths {sorted(widths)} outside the shapes phase 2 compared")
    res["profile"] = profile_encode(torch, embedder, index, keys[:1024], docs[:1024])

    zero = [name for name, n in res["launches"].items() if n == 0]
    if zero:
        fail(f"kernels not launched on the main path: {zero}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs the port on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pathway_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in _build.NAMES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)
    dev = torch.device("cuda:0")

    k_out = phase_kernels(torch, dev)
    by_nq = k_out.pop("_knn_topk_by_nq")
    paths = k_out.pop("_knn_paths")
    k128 = k_out.pop("_knn_k128")
    attn_l512 = k_out.pop("_attention_b32_l512")
    torch.cuda.empty_cache()
    s_out = phase_slice(torch, dev)

    sources = {
        "attention": ("pathway_tpu_torch/kernels/csrc/attention.cu", "pathway_tpu/models/encoder.py:113"),
        "slab_scatter": ("pathway_tpu_torch/kernels/csrc/slab_scatter.cu", "pathway_tpu/parallel/sharded_knn.py:166"),
        "slab_clear": ("pathway_tpu_torch/kernels/csrc/slab_scatter.cu", "pathway_tpu/parallel/sharded_knn.py:133"),
        "knn_topk": ("pathway_tpu_torch/kernels/csrc/knn_topk.cu", "pathway_tpu/parallel/sharded_knn.py:336"),
    }
    entries = []
    for name, (src, replaces) in sources.items():
        m = k_out[name]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": s_out["launches"][name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"], "shape": m["shape"],
            **({"device_ms": m["device_ms"]} if "device_ms" in m else {}),
        })
    summary = {
        "card": smi,
        "embed_docs_per_s": s_out["embed_docs_per_s"],
        "encoder_batches": s_out["encoder_batches"],
        "bulk_rows_per_s": s_out["bulk_rows_per_s"],
        "search": s_out["search"],
        "peak_mem_gb": s_out["peak_mem_gb"],
        "transfers": s_out["transfers"],
        "knn_topk_by_nq": by_nq,
        "knn_pass1_paths": paths,
        "knn_topk_k128_ms": k128,
        "attention_b32_l512": attn_l512,
        "attention_widths": s_out["attention_widths"],
        "tokenize_tokens_per_s": s_out["tokenize_tokens_per_s"],
        "profile": s_out["profile"],
    }
    log("summary: " + json.dumps(summary))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
