"""The port's plain ops (``pathway_tpu_torch.ops``) against the JAX
package's, on the CPU, from the same seeded numpy inputs.

Tolerance: f32 atol 1e-5 (the two libraries sum in other orders).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pathway_tpu.ops import bucketing as jbucket
from pathway_tpu.ops import distances as jdist
from pathway_tpu.ops import pooling as jpool
from pathway_tpu.ops import topk as jtopk
from pathway_tpu_torch.ops import bucketing as tbucket
from pathway_tpu_torch.ops import distances as tdist
from pathway_tpu_torch.ops import pooling as tpool
from pathway_tpu_torch.ops import topk as ttopk

ATOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["dot_scores", "cosine_scores", "l2sq_distances"])
def test_pairwise_scores_match_jax(fn):
    q, c = _rand(7, 32, seed=1), _rand(50, 32, seed=2)
    want = np.asarray(getattr(jdist, fn)(jnp.asarray(q), jnp.asarray(c)))
    got = getattr(tdist, fn)(_t(q), _t(c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_l2sq_clamps_at_zero_like_jax():
    x = _rand(4, 16, seed=3)
    got = tdist.l2sq_distances(_t(x), _t(x)).numpy()
    want = np.asarray(jdist.l2sq_distances(jnp.asarray(x), jnp.asarray(x)))
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("scale", [1.0, 1e-20])
def test_normalize_matches_jax_including_tiny_rows(scale):
    x = _rand(9, 24, seed=4) * np.float32(scale)
    x[3] = 0.0
    got = tdist.normalize(_t(x)).numpy()
    want = np.asarray(jdist.normalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_normalize_bf16_matches_jax():
    x = _rand(5, 64, seed=5)
    got = tdist.normalize(_t(x).to(torch.bfloat16)).float().numpy()
    want = np.asarray(jdist.normalize(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.parametrize("lens", [[5, 1, 3, 8], [0, 2, 8, 4]])
def test_pooling_matches_jax(lens):
    h = _rand(4, 8, 16, seed=6)
    mask = (np.arange(8)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    np.testing.assert_allclose(
        tpool.masked_mean_pool(_t(h), _t(mask)).numpy(),
        np.asarray(jpool.masked_mean_pool(jnp.asarray(h), jnp.asarray(mask))),
        atol=ATOL,
    )
    np.testing.assert_array_equal(
        tpool.cls_pool(_t(h), _t(mask)).numpy(), np.asarray(jpool.cls_pool(jnp.asarray(h)))
    )


@pytest.mark.parametrize("k,live", [(5, 40), (10, 40), (8, 3)])
def test_masked_top_k_matches_jax(k, live):
    """Values agree; slots agree away from ties; where k exceeds the live
    columns, the rest are sentinels <= NEG_INF/2 on both sides."""
    s = _rand(6, 40, seed=7)
    valid = np.zeros(40, np.float32)
    valid[np.random.default_rng(8).permutation(40)[:live]] = 1.0
    jv, ji = jtopk.masked_top_k(jnp.asarray(s), jnp.asarray(valid), k)
    tv, ti = ttopk.masked_top_k(_t(s), _t(valid), k)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    real = jv > ttopk.NEG_INF / 2
    assert real.sum(axis=1).tolist() == [min(k, live)] * 6
    np.testing.assert_array_equal(ti[real], ji[real])
    assert (tv[~real] <= ttopk.NEG_INF / 2).all()
    assert ttopk.NEG_INF == jtopk.NEG_INF


def test_masked_top_k_without_mask():
    s = _rand(3, 20, seed=9)
    jv, ji = jtopk.masked_top_k(jnp.asarray(s), None, 4)
    tv, ti = ttopk.masked_top_k(_t(s), None, 4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize(
    "n,kw", [(0, {}), (1, {}), (9, {}), (16, {"min_bucket": 16}), (300, {"max_bucket": 256})]
)
def test_bucketing_is_the_same_copy(n, kw):
    assert tbucket.bucket_size(n, **kw) == jbucket.bucket_size(n, **kw)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tbucket.pad_rows(a, 8, 7), jbucket.pad_rows(a, 8, 7))
    np.testing.assert_array_equal(tbucket.pad_dim(a, 1, 6), jbucket.pad_dim(a, 1, 6))
