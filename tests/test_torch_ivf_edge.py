"""The yardstick that phase 2 of ``chip_smoke.py`` holds K11, K12 and K10
to where q.x is near |q||x| (ROADMAP C15), as ``test_torch_knn_edge.py``
does for K3: each kernel's plain version on ``k3_edge_slab``'s rows (unit
rows at d = 768, their near-duplicates at cosines 0.99-0.9999, and
unrelated rows) against float64.

- ``ivf_assign_plain``, both forms, with centroids seeded from slab rows
  as ``_kmeans`` seeds them: no row decided by more than ``ASSIGN_ATOL``
  in float64 is assigned elsewhere, the chosen centroid is within
  ``ASSIGN_ATOL`` of float64's best, and every seeded row takes its own
  centroid.
- ``ivf_scan_plain`` over f32 and bf16 cells, queried by stored rows that
  probe their own cells first: scores within ``TOPK_ATOL`` of float64 of
  the rows (for bf16 cells, of the bf16-rounded query and rows), and over
  f32 cells each row its own first neighbour.
- ``dual_logits_plain`` at phase 5's shape (256 images x 256 captions) at
  the logit scale e^2.3: within ``LOGIT_ATOL`` of float64.

The kernels themselves run only on the card (phase 2's case,
``c15_edge_cases``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import chip_smoke
from pathway_tpu_torch.kernels import dual_logits_plain, ivf_assign_plain, ivf_scan_plain

CAP = 512  # chip_smoke.C15_SCAN_CAP


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


@pytest.mark.parametrize("half_norm", [False, True], ids=["ip", "lloyd"])
@pytest.mark.parametrize("nlist", [1024, 1280])
def test_assign_plain_within_assign_atol_of_f64(edge, half_norm, nlist):
    slab, seeds = edge["slab"], edge["edge_slots"][:nlist]
    c = slab[seeds]
    s64 = slab.double() @ c.double().T
    if half_norm:
        s64 -= 0.5 * (c.double() ** 2).sum(1)
    top = s64.topk(2, dim=1)
    decided = (top.values[:, 0] - top.values[:, 1]) > chip_smoke.ASSIGN_ATOL
    got = ivf_assign_plain(slab, c, half_norm).long()
    assert torch.equal(got[decided], top.indices[decided, 0])
    assert float((top.values[:, 0] - s64.gather(1, got[:, None])[:, 0]).max()) <= chip_smoke.ASSIGN_ATOL
    assert torch.equal(got[seeds], torch.arange(nlist))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nq", [1, 32])
def test_scan_plain_within_topk_atol_of_f64(edge, dtype, nq):
    slab, valid, queries = edge["slab"], edge["valid"], edge["queries"]
    nlist = slab.shape[0] // CAP
    cells, vcells = slab.reshape(nlist, CAP, -1).to(dtype), valid.reshape(nlist, CAP)
    own = [int(s) // CAP for s in edge["self_slot"][:nq]]
    probe = torch.tensor([[o] + [c for c in range(nlist) if c != o][:3] for o in own], dtype=torch.int32)
    vals, flat = ivf_scan_plain(queries[:nq], probe, cells, vcells, chip_smoke.EDGE_K)
    rows64 = cells.double().reshape(-1, slab.shape[1])
    exact = (queries[:nq].to(dtype).double()[:, None, :] * rows64[flat.long()]).sum(-1)
    assert float((vals.double() - exact).abs().max()) <= chip_smoke.TOPK_ATOL
    if dtype == torch.float32:
        assert torch.equal(flat[:, 0].long(), edge["self_slot"][:nq])


@pytest.mark.parametrize("group", ["base", "near 0.99", "near 0.9999", "random"])
def test_logits_plain_within_logit_atol_of_f64(edge, group):
    rows = edge["slab"][edge["edge_slots"]]
    n = chip_smoke.EDGE_BASE
    at = {"base": 0, "near 0.99": 1, "near 0.9999": 3, "random": 1 + len(chip_smoke.EDGE_COS)}[group]
    img, txt = rows[:n], rows[at * n:(at + 1) * n]
    scale, bias = torch.tensor(2.3), torch.tensor(-0.5)
    got = dual_logits_plain(img, txt, scale, bias)
    want = (img.double() @ txt.double().T) * math.exp(scale.item()) + bias.item()
    assert got.shape == (n, n)
    assert float((got.double() - want).abs().max()) <= chip_smoke.LOGIT_ATOL
