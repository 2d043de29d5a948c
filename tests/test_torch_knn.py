"""The port's ``ShardedKnnIndex`` against the JAX package's, on the CPU.

The same operations on the same seeded numpy data (host and device
upserts, removals, a grow past capacity, searches) must give the same
keys, and scores within 1e-5 (f32 sums in another order).  A bf16 slab
holds the same bf16 values on both sides; its scores get 1e-3, because
the device-side normalize may differ by one f32 ulp and flip a bf16
rounding.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex
from pathway_tpu_torch.kernels import knn_topk, knn_topk_plain, slab_scatter, slab_scatter_plain
from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh

DIM = 32
_TOL = {"f32": 1e-5, "bf16": 1e-3}
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _vecs(n, seed):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _pair(metric, dtype, capacity=128):
    jd, td = _DT[dtype]
    return (
        JaxIndex(DIM, metric=metric, capacity=capacity, dtype=jd),
        ShardedKnnIndex(DIM, metric=metric, capacity=capacity, dtype=td, device="cpu"),
    )


def _same_results(a, b, tol):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [k for k, _ in ra] == [k for k, _ in rb]
        np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb], atol=tol)


def _drive(jidx, tidx):
    """One op sequence on both indexes; yields after each step."""
    jidx.add_batch([f"h{i}" for i in range(60)], _vecs(60, 1))
    tidx.add_batch([f"h{i}" for i in range(60)], _vecs(60, 1))
    yield
    dev = _vecs(40, 2)
    pad = np.concatenate([dev, _vecs(24, 3)])  # encoder-style padded rows
    keys = [f"d{i}" for i in range(40)]
    jidx.add_batch_device(keys, jnp.asarray(pad), n_valid=40)
    tidx.add_batch_device(keys, torch.from_numpy(pad), n_valid=40)
    yield
    gone = [f"h{i}" for i in range(0, 60, 3)] + ["d5", "missing"]
    jidx.remove(gone)
    tidx.remove(gone)
    yield
    # past the capacity of 128: both grow 2x
    more = [f"g{i}" for i in range(100)]
    jidx.add_batch(more, _vecs(100, 4))
    tidx.add_batch(more, _vecs(100, 4))
    assert jidx.capacity == tidx.capacity == 256
    yield
    # upsert of live keys moves nothing, rewrites rows
    jidx.add_batch(["h1", "d7"], _vecs(2, 5))
    tidx.add_batch(["h1", "d7"], _vecs(2, 5))
    yield


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_same_ops_same_results(metric, dtype):
    jidx, tidx = _pair(metric, dtype)
    queries = _vecs(5, 9)
    for _ in _drive(jidx, tidx):
        assert jidx._slot_of == tidx._slot_of
        assert sorted(jidx._free) == sorted(tidx._free)
        _same_results(jidx.search(queries, 7), tidx.search(queries, 7), _TOL[dtype])
    assert len(jidx) == len(tidx) == 60 + 40 - 21 + 100


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_jax_state_dict_loads_and_searches_identically(metric):
    jidx, tidx = _pair(metric, "f32")
    for _ in _drive(jidx, tidx):
        pass
    port = ShardedKnnIndex(DIM, metric=metric, capacity=128, device="cpu")
    port.load_state_dict(jidx.state_dict())
    queries = _vecs(4, 10)
    _same_results(jidx.search(queries, 10), port.search(queries, 10), 1e-5)
    # and back: the port's state loads into the JAX index
    back = JaxIndex(DIM, metric=metric, capacity=128)
    back.load_state_dict(port.state_dict())
    _same_results(back.search(queries, 10), port.search(queries, 10), 1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_state_dict_is_a_snapshot(dtype):
    """The state's arrays do not change with the index afterwards, as the
    JAX index's (host copies) do not; on the CPU they are copies too, not
    views of the index's tensors."""
    _, tidx = _pair("cos", dtype)
    tidx.add_batch(["a", "b"], _vecs(2, 1))
    state = tidx.state_dict()
    vectors, valid = state["vectors"].copy(), state["valid"].copy()
    tidx.add_batch(["a", "c"], _vecs(2, 2))
    tidx.remove(["b"])
    np.testing.assert_array_equal(state["vectors"], vectors)
    np.testing.assert_array_equal(state["valid"], valid)


def test_pre_restore_handle_raises():
    idx = ShardedKnnIndex(DIM, capacity=128, device="cpu")
    idx.add_batch(["a", "b"], _vecs(2, 1))
    state = idx.state_dict()
    handle = idx.dispatch(_vecs(1, 2), 2)
    idx.load_state_dict(state)
    with pytest.raises(RuntimeError, match="stale dispatch handle"):
        idx.collect(handle)


def test_slot_freed_in_flight_stays_quarantined():
    idx = ShardedKnnIndex(DIM, capacity=128, device="cpu")
    idx.add_batch(["a", "b", "c"], _vecs(3, 1))
    slot_b = idx._slot_of["b"]
    handle = idx.dispatch(_vecs(2, 2), 3)
    idx.remove(["b"])
    assert slot_b in idx._quarantine and slot_b not in idx._free
    idx.add_batch(["new"], _vecs(1, 3))
    assert idx._slot_of["new"] != slot_b
    rows = idx.collect(handle)
    assert all(key in ("a", "c") for row in rows for key, _ in row)
    assert slot_b in idx._free and not idx._quarantine


def test_grow_keeps_handles_valid():
    jidx, tidx = _pair("cos", "f32")
    keys = [f"k{i}" for i in range(128)]
    tidx.add_batch(keys, _vecs(128, 1))
    jidx.add_batch(keys, _vecs(128, 1))
    q = _vecs(3, 2)
    handle = tidx.dispatch(q, 5)
    tidx.add_batch(["extra"], _vecs(1, 3))
    assert tidx.capacity == 256
    _same_results(tidx.collect(handle), jidx.search(q, 5), 1e-5)


def test_empty_index_and_empty_queries():
    idx = ShardedKnnIndex(DIM, capacity=128, device="cpu")
    assert idx.search(_vecs(2, 1), 3) == [[], []]
    idx.add_batch(["a"], _vecs(1, 1))
    assert idx.search(np.zeros((0, DIM), np.float32), 3) == []
    # k past the live rows: masked sentinels are dropped
    assert [k for k, _ in idx.search(_vecs(1, 2), 5)[0]] == ["a"]


def test_rejects_bad_shapes_and_metric():
    with pytest.raises(ValueError):
        ShardedKnnIndex(DIM, metric="hamming", device="cpu")
    idx = ShardedKnnIndex(DIM, device="cpu")
    with pytest.raises(ValueError):
        idx.add_batch(["a"], np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(ValueError):
        idx.add_batch_device(["a", "b"], torch.zeros((1, DIM)))
    # a "model" axis replicates the slab, as the JAX index does; other axes raise
    assert ShardedKnnIndex(DIM, mesh=make_mesh({"data": 4, "model": 2}, ["cpu"] * 8)).shards == 4
    with pytest.raises(NotImplementedError, match="besides"):
        ShardedKnnIndex(DIM, mesh=make_mesh({"data": 4, "x": 2}, ["cpu"] * 8))


def test_scatter_plain_normalizes_with_ingest_eps_and_drops_pads():
    """K2's plain version: eps 1e-30 (not 1e-12), pads at capacity dropped."""
    slab = torch.zeros((8, 4))
    valid = torch.zeros(8)
    vals = torch.tensor([[3.0, 4.0, 0.0, 0.0], [1e-20, 0.0, 0.0, 0.0], [9.0, 9.0, 9.0, 9.0]])
    slots = torch.tensor([2, 5, 8], dtype=torch.int32)
    slab_scatter(slab, valid, slots, vals, True)  # CPU tensors: the plain version
    torch.testing.assert_close(slab[2], torch.tensor([0.6, 0.8, 0.0, 0.0]))
    torch.testing.assert_close(slab[5], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert valid.tolist() == [0, 0, 1, 0, 0, 1, 0, 0]
    assert slab[[0, 1, 3, 4, 6, 7]].abs().sum() == 0
    slab2, valid2 = torch.zeros((8, 4)), torch.zeros(8)
    slab_scatter_plain(slab2, valid2, slots, vals, False)
    torch.testing.assert_close(slab2[2], vals[0])


@pytest.mark.parametrize("metric", ["dot", "l2sq"])
def test_knn_topk_plain_matches_jax_search_program(metric):
    """K3's plain version against the JAX index's search program on the
    same slab, with a bf16 slab rounding the queries as JAX does."""
    jidx = JaxIndex(DIM, metric=metric, capacity=128, dtype=jnp.bfloat16)
    jidx.add_batch([f"k{i}" for i in range(90)], _vecs(90, 1))
    jidx.remove([f"k{i}" for i in range(0, 90, 4)])
    q = _vecs(3, 2)
    jv, ji = jidx._search_jit(12)(jnp.asarray(q), jidx._vectors, jidx._valid)
    slab = torch.from_numpy(np.array(jidx._vectors.astype(jnp.float32))).to(torch.bfloat16)
    valid = torch.from_numpy(np.array(jidx._valid))
    tv, ti = knn_topk(torch.from_numpy(q), slab, valid, 12, metric)
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    torch.testing.assert_close(knn_topk_plain(torch.from_numpy(q), slab, valid, 12, metric)[0], tv)


def test_knn_topk_rejects_bad_k():
    slab, valid = torch.zeros((4, DIM)), torch.ones(4)
    with pytest.raises(ValueError, match="k=5"):
        knn_topk(torch.zeros((1, DIM)), slab, valid, 5, "dot")
    with pytest.raises(ValueError, match="metric"):
        knn_topk(torch.zeros((1, DIM)), slab, valid, 2, "cos")


def test_knn_topk_checks_refuse_what_the_kernels_do_not_take():
    from pathway_tpu_torch.kernels.knn_topk import check_knn_topk

    slab, valid, q = torch.zeros((64, DIM)), torch.ones(64), torch.zeros((3, DIM))
    check_knn_topk(q, slab, valid)
    check_knn_topk(q, slab.bfloat16(), valid)
    with pytest.raises(ValueError, match="f32 or bf16"):
        check_knn_topk(q, slab.half(), valid)
    with pytest.raises(ValueError, match="divide by 4"):
        check_knn_topk(torch.zeros((3, 6)), torch.zeros((64, 6)), valid)
    with pytest.raises(ValueError, match="divide by 8"):
        check_knn_topk(torch.zeros((3, 12)), torch.zeros((64, 12), dtype=torch.bfloat16), valid)
    with pytest.raises(ValueError, match="<= 1024"):
        check_knn_topk(torch.zeros((3, 1028)), torch.zeros((64, 1028)), valid)
    with pytest.raises(ValueError, match="queries"):
        check_knn_topk(q.double(), slab, valid)
    with pytest.raises(ValueError, match="valid"):
        check_knn_topk(q, slab, torch.ones(63))
    with pytest.raises(ValueError, match="int32"):
        check_knn_topk(q, slab, valid, offset=2**31 - 64)
    # the tensor-core pass reads the slab by TMA: 16-byte aligned rows
    with pytest.raises(ValueError, match="16-byte"):
        check_knn_topk(q, torch.zeros((65 * DIM + 1,))[1:].view(65, DIM), torch.ones(65))


@pytest.mark.parametrize(("nq", "want"), [(1, (8, 1)), (8, (8, 1)), (9, (16, 1)), (16, (16, 1)), (17, (32, 1)),
                                          (32, (32, 1)), (33, (64, 1)), (64, (64, 1)), (65, (64, 2)),
                                          (256, (64, 4))])
def test_tiled_groups_read_the_slab_once_up_to_64_queries(nq, want):
    from pathway_tpu_torch.kernels.knn_topk import tiled_groups

    assert tiled_groups(nq) == want


@pytest.mark.parametrize(("n_in", "k", "want"), [(10, 10, 0), (132 * 10, 10, 2), (4096 * 10, 10, 2),
                                                 (132 * 128, 128, 3), (4 * 128, 128, 1), (4096 * 128, 128, 4)])
def test_merge_passes_count_the_launches_of_merge_partials(n_in, k, want):
    from pathway_tpu_torch.kernels.knn_topk import merge_passes

    # one list a block of the tensor-core pass (132 blocks, one an SM of an
    # H100), one a tile (4,096 tiles of 256 rows of a 1M slab), and the
    # four blocks of the IVF's 1,024-centroid probe
    assert merge_passes(n_in, k) == want
