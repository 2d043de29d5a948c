"""The arithmetic of K3, K10 and K11's 3xTF32 tensor-core products
(``pathway_tpu_torch/kernels/csrc/tf32x3.cuh``), emulated in plain torch
on the CPU, against the JAX programs the kernels replace.

The kernels split each f32 operand into a TF32 high part ``hi = rna(x)``
(``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away from zero)
and the TF32 rounding of the rest, ``lo = rna(x - hi)``, and take a.b as
``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` per 8-deep step, in that order,
into one f32 accumulator.  The emulation repeats that with f32 sums (each
product of two TF32 values is exact in f32; the tensor cores' own order
inside an 8-deep step is not modelled).  K10 also splits d over the 8
blocks of a cluster (96 values each at d = 768), sums each 16-value stage
of a block apart and adds it to the block's partial tile (C15), and sums
the 8 partial tiles in block order before the rounded multiply by e^s and
add of b.

Held against, on the same seeded numpy inputs:
  - ``pathway_tpu.parallel.ivf_knn._assign_ip`` and the Lloyd score of
    ``_kmeans`` (``x @ c.T - 0.5 * sum(c * c, axis=1)``) with the gates of
    ``chip_smoke.check_assign``: rows whose top-2 JAX scores differ by more
    than ``ASSIGN_ATOL`` (1e-5) pick the same centroid, and no row's pick
    scores more than 1e-5 below the best;
  - ``img @ txt.T * jnp.exp(s) + b`` (``pathway_tpu/models/vision.py:120``)
    within ``LOGIT_ATOL`` (1e-5);
  - K3's tiled pass (slab rows as A, queries as B, 16 values of d a stage):
    ``jax.lax.top_k`` of the f32 ``q @ slab.T``, the JAX search program's
    dot scores, at 32 queries over 65,536 unit rows of 768, with the gate of
    ``chip_smoke.compare_topk``: values within ``TOPK_ATOL`` (1e-5), and
    every slot the f32 top-k ranks clear of its k-th value by more than
    that is in the list.
A single TF32 pass (``hi.hi``) fails each of those gates on the same data:
the case that shows the tests can tell.  The K11 data are unit mixture
rows against centroids in close pairs, so many rows' top-2 margins lie
near the gate.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from pathway_tpu.parallel import ivf_knn as jax_ivf

ASSIGN_ATOL = chip_smoke.ASSIGN_ATOL
LOGIT_ATOL = chip_smoke.LOGIT_ATOL
TOPK_ATOL = chip_smoke.TOPK_ATOL
SPLIT = 8  # K10's blocks a cluster
STEP = 16  # values of d a stage


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulation's small products run faster on one thread, and leave
    the other cores to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of an f32 tensor: round the 23-bit mantissa to
    10 bits, to nearest, ties away from zero (non-finite values kept)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3, acc: torch.Tensor | None = None) -> torch.Tensor:
    """``acc + a @ b.T`` as the kernels take it: per 8-deep step, lo.hi,
    hi.lo, hi.hi (``passes=3``), or hi.hi alone (``passes=1``)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    acc = torch.zeros((a.shape[0], b.shape[0])) if acc is None else acc
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if passes == 3:
            acc = acc + al[:, s] @ bh[:, s].T
            acc = acc + ah[:, s] @ bl[:, s].T
        acc = acc + ah[:, s] @ bh[:, s].T
    return acc


def ivf_scores(x: torch.Tensor, c: torch.Tensor, half_norm: bool, passes: int) -> torch.Tensor:
    scores = mm_tf32(x, c, passes)
    if half_norm:
        scores = scores - 0.5 * (c * c).sum(1)
    return scores


def dual_logits_tf32(img, txt, scale, bias, passes: int = 3) -> torch.Tensor:
    """K10: d split over SPLIT blocks in whole stages, each stage's
    products summed apart and added to its block's partial, the partials
    summed in block order, then ``* e^s`` and ``+ b``, each rounded."""
    d = img.shape[1]
    steps = -(-d // STEP)
    per = -(-steps // SPLIT)
    total = torch.zeros((img.shape[0], txt.shape[0]))
    for rank in range(SPLIT):
        part = torch.zeros_like(total)
        for st in range(min(steps, rank * per), min(steps, (rank + 1) * per)):
            lo, hi = st * STEP, min(d, (st + 1) * STEP)
            part = part + mm_tf32(img[:, lo:hi], txt[:, lo:hi], passes)
        total = total + part
    return total * torch.exp(scale) + bias


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _ivf_data(seed: int = 0, n: int = 4096, nlist: int = 256, d: int = 768):
    """Unit mixture rows (``tests/test_ivf.py``'s clusters) and centroids in
    close pairs (each odd one its even neighbour moved by ~3e-3)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32) * 3.0
    x = _unit(centers[rng.integers(0, 64, n)] + rng.normal(size=(n, d)).astype(np.float32))
    c = _unit(centers[rng.integers(0, 64, nlist)] + rng.normal(size=(nlist, d)).astype(np.float32))
    c[1::2] = _unit(c[0::2] + 3e-3 * rng.normal(size=(nlist // 2, d)).astype(np.float32))
    return x, c * np.float32(1.3)


def _assign_gate(got: np.ndarray, want: np.ndarray, want_scores: np.ndarray) -> tuple[int, float]:
    """``chip_smoke.check_assign``'s two numbers: decided rows that differ,
    and the largest shortfall of a pick below the best score."""
    rows = np.arange(len(got))
    top2 = np.sort(want_scores, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > ASSIGN_ATOL
    short = float((want_scores[rows, want] - want_scores[rows, got]).max())
    return int(((got != want) & decided).sum()), short


def _jax_assign(x: np.ndarray, c: np.ndarray, half_norm: bool) -> tuple[np.ndarray, np.ndarray]:
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    if half_norm:  # _kmeans.assign's score
        scores = xj @ cj.T - 0.5 * jnp.sum(cj * cj, axis=1)[None, :]
        return np.asarray(jnp.argmax(scores, axis=1)), np.asarray(scores)
    return np.asarray(jax_ivf._assign_ip(xj, cj)), np.asarray(xj @ cj.T)


@pytest.mark.parametrize(
    ("x", "want"),
    [
        (1.0 + 2.0**-11, 1.0 + 2.0**-10),  # a tie: away from zero
        (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
        (1.0 + 2.0**-11 - 2.0**-23, 1.0),  # below the tie: down
        (1.0 + 3 * 2.0**-11, 1.0 + 2 * 2.0**-10),  # a tie at an odd mantissa: away, not to even
        (2.0**-130, 2.0**-130),  # a subnormal within TF32's 10 mantissa bits
        (2.0**-140, 0.0),  # ... and one below them
        (float("inf"), float("inf")),
    ],
)
def test_tf32_rounding_is_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert (got.view(torch.int32) & 0x1FFF).item() == 0 or not np.isfinite(x)


def test_split_keeps_about_22_bits():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=100_000).astype(np.float32))
    hi, lo = split_tf32(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-21
    assert ((x - hi).abs() <= x.abs() * 2.0**-11).all()


@pytest.mark.parametrize("half_norm", [False, True], ids=["_assign_ip", "_kmeans.assign"])
def test_ivf_assign_3xtf32_keeps_the_assign_gates(half_norm):
    x, c = _ivf_data()
    want, want_scores = _jax_assign(x, c, half_norm)
    scores = ivf_scores(torch.from_numpy(x), torch.from_numpy(c), half_norm, passes=3)
    got = torch.argmax(scores, dim=1).numpy()
    differ, short = _assign_gate(got, want, want_scores)
    assert differ == 0
    assert short <= ASSIGN_ATOL
    assert np.abs(scores.numpy() - want_scores).max() <= ASSIGN_ATOL / 2


@pytest.mark.parametrize("half_norm", [False, True], ids=["_assign_ip", "_kmeans.assign"])
def test_ivf_assign_one_tf32_pass_fails_the_assign_gates(half_norm):
    x, c = _ivf_data()
    want, want_scores = _jax_assign(x, c, half_norm)
    got = torch.argmax(ivf_scores(torch.from_numpy(x), torch.from_numpy(c), half_norm, passes=1), dim=1).numpy()
    differ, short = _assign_gate(got, want, want_scores)
    assert differ > 0 or short > ASSIGN_ATOL


def _jax_logits(img, txt, s, b) -> np.ndarray:
    return np.asarray(jnp.asarray(img) @ jnp.asarray(txt).T * jnp.exp(jnp.float32(s)) + jnp.float32(b))


@pytest.mark.parametrize(("m", "n"), [(256, 256), (100, 37), (1, 256)])
def test_dual_logits_3xtf32_within_the_logit_gate(m, n):
    """K10's three shapes in ``chip_smoke.py``: unit rows, e^2.3, b = -0.5."""
    rng = np.random.default_rng(9)
    img, txt = _unit(rng.normal(size=(256, 768))), _unit(rng.normal(size=(256, 768)))
    img, txt = img[:m], txt[:n]
    want = _jax_logits(img, txt, 2.3, -0.5)
    got = dual_logits_tf32(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(2.3), torch.tensor(-0.5))
    assert got.shape == (m, n)
    assert np.abs(got.numpy() - want).max() <= LOGIT_ATOL


def test_dual_logits_one_tf32_pass_misses_the_logit_gate():
    rng = np.random.default_rng(9)
    img, txt = _unit(rng.normal(size=(256, 768))), _unit(rng.normal(size=(256, 768)))
    want = _jax_logits(img, txt, 2.3, -0.5)
    got = dual_logits_tf32(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(2.3), torch.tensor(-0.5),
                           passes=1)
    assert np.abs(got.numpy() - want).max() > LOGIT_ATOL


def _knn_data(seed: int = 3, n: int = 65536, nq: int = 32, d: int = 768):
    rng = np.random.default_rng(seed)
    return _unit(rng.normal(size=(n, d)).astype(np.float32)), _unit(rng.normal(size=(nq, d)).astype(np.float32))


def _topk_gate(vals: np.ndarray, ids: np.ndarray, want_vals: np.ndarray, want_ids: np.ndarray) -> tuple[float, int]:
    """``chip_smoke.compare_topk``'s numbers: the largest value difference,
    and how many slots ranked clear of the k-th value by more than
    TOPK_ATOL are missing from the list."""
    err = float(np.abs(vals - want_vals).max())
    missing = 0
    for r in range(len(want_ids)):
        sure = set(want_ids[r][want_vals[r] > want_vals[r, -1] + TOPK_ATOL].tolist())
        missing += len(sure - set(ids[r].tolist()))
    return err, missing


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one_tf32_pass"])
def test_knn_tiled_pass_3xtf32_keeps_the_topk_gate(passes):
    slab, q = _knn_data()
    jv, ji = jax.lax.top_k(jnp.asarray(q) @ jnp.asarray(slab).T, 10)
    scores = mm_tf32(torch.from_numpy(slab), torch.from_numpy(q), passes).T
    vals, ids = torch.topk(scores, 10)
    err, missing = _topk_gate(vals.numpy(), ids.numpy(), np.asarray(jv), np.asarray(ji))
    if passes == 3:
        assert err <= TOPK_ATOL and missing == 0, (err, missing)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))  # no near-tie at this seed
    else:  # one pass misses it on the same data
        assert err > TOPK_ATOL, err
