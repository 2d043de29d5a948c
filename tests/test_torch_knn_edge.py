"""The yardstick that phase 2 of ``chip_smoke.py`` holds K3 to where q.x
is near |q||x| (ROADMAP C13): K3's plain version (``knn_topk_plain``, the
f32 ``|q|^2 + |x|^2 - 2 q.x`` expansion for l2sq) on ``k3_edge_slab``'s
rows (unit rows at d = 768 queried against themselves, their
near-duplicates at cosines 0.99-0.9999, and unrelated rows) is within
``TOPK_ATOL`` of float64 on the slots it returns, each row comes back as
its own first neighbour with its three near-duplicates next in order of
cosine, and a row's l2sq distance to itself is below ``TOPK_ATOL``.  The
kernel itself runs only on the card (phase 2's case, ``k3_edge_cases``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from pathway_tpu_torch.kernels import knn_topk_plain


@pytest.fixture(scope="module")
def edge():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = chip_smoke.EDGE_SLAB
    chip_smoke.EDGE_SLAB = 4096  # the structured rows among fewer fillers
    try:
        yield chip_smoke.k3_edge_slab(np, torch, torch.device("cpu"))
    finally:
        chip_smoke.EDGE_SLAB = saved
        torch.set_num_threads(threads)


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
@pytest.mark.parametrize("nq", [1, 8, 320], ids=["one", "eight", "all"])
def test_plain_version_within_topk_atol_of_f64_near_self(edge, metric, nq):
    slab, valid, queries = edge["slab"], edge["valid"], edge["queries"][:nq]
    vals, slots = knn_topk_plain(queries, slab, valid, chip_smoke.EDGE_K, metric)
    q64, x64 = queries.double()[:, None, :], slab.double()[slots.long()]
    exact = (q64 * x64).sum(-1) if metric == "dot" else -((q64 - x64) ** 2).sum(-1)
    assert float((vals.double() - exact).abs().max()) <= chip_smoke.TOPK_ATOL
    n_base = min(nq, chip_smoke.EDGE_BASE)
    own = edge["self_slot"][:n_base]
    assert torch.equal(slots[:n_base, 0].long(), own)
    # the near-duplicates follow, closest (cosine 0.9999) first
    assert torch.equal(slots[:n_base, 1:4].long(), edge["near_slots"].flip(0).T[:n_base])
    if metric == "l2sq":
        assert float(-vals[:n_base, 0].min()) < chip_smoke.TOPK_ATOL
        assert float(vals.max()) <= 0.0
