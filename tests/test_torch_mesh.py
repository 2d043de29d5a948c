"""The port's mesh, sharded index (B12) and data-parallel encoder against
the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device CPU mesh (``conftest.py``); the
port's mesh names the CPU device eight times, which is how the port runs
a sharded index without eight cards (``parallel/mesh.py``).  The same
operations on the same seeded numpy data must give the same keys, and
scores within 1e-5 (f32 dots summed in another order); the data-parallel
encoder's embeddings within 1e-4 (the f32 encoder tolerance of
``test_torch_slice.py``).  K13's plain version is held to
``jax.lax.top_k``: equal values and positions on tie-free rows.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex
from pathway_tpu.parallel import best_mesh as jax_best_mesh
from pathway_tpu.parallel import make_mesh as jax_make_mesh
from pathway_tpu.parallel import mesh_axis_size as jax_mesh_axis_size
from pathway_tpu_torch import best_mesh, make_mesh, mesh_axis_size
from pathway_tpu_torch.kernels import knn_topk_plain, topk_select, topk_select_plain
from pathway_tpu_torch.kernels.topk_select import MAX_LEN, MAX_ROWS, MAX_SLOTS, select_plan
from pathway_tpu_torch.ops.topk import NEG_INF
from pathway_tpu_torch.kernels.knn_topk import merge_partials
from pathway_tpu_torch.parallel import ShardedKnnIndex, TorchEncoder
from test_torch_encoder import port_config
from test_torch_slice import _texts


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DIM = 32
TOL = 1e-5
ENC_TOL = 1e-4
CPU8 = ["cpu"] * 8


def _vecs(n, seed):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _same(a, b, tol=TOL):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [k for k, _ in ra] == [k for k, _ in rb]
        np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb], atol=tol)


# ---------------------------------------------------------------------------
# the mesh


def test_make_mesh_shapes_and_errors_match_jax():
    jm, tm = jax_make_mesh(), make_mesh(devices=CPU8)
    assert dict(jm.shape) == tm.shape == {"data": 8}
    assert tm.axis_names == tuple(jm.axis_names) and tm.devices.shape == (8,)
    assert all(d == torch.device("cpu") for d in tm.devices_along("data"))
    for axes in ({"data": 2, "model": 4}, {"model": 8}, {"a": 2, "b": 2, "c": 2}):
        jm, tm = jax_make_mesh(axes), make_mesh(axes, CPU8)
        assert dict(jm.shape) == tm.shape and tm.devices.shape == tuple(axes.values())
        assert [jax_mesh_axis_size(jm, a) for a in ("data", "model", "x")] == [
            mesh_axis_size(tm, a) for a in ("data", "model", "x")]
    for bad in ({"data": 3}, {"data": 4, "model": 4}):
        with pytest.raises(ValueError, match="need"):
            jax_make_mesh(bad)
        with pytest.raises(ValueError, match="need"):
            make_mesh(bad, CPU8)
    for mp in (0, 1, 2, 3, 8, 9):
        assert dict(jax_best_mesh(mp).shape) == best_mesh(mp, CPU8).shape
    assert mesh_axis_size(None, "data") == jax_mesh_axis_size(None, "data") == 1
    assert make_mesh({"data": 2}, ["cpu", torch.device("cpu")]).devices_along("data") == [
        torch.device("cpu")] * 2


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is usable")
    for build in (make_mesh, best_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# ---------------------------------------------------------------------------
# the sharded index (B12)


def _pair(metric, capacity=64, shards=8, dim=DIM):
    jmesh = jax_make_mesh({"data": shards}, jax.devices()[:shards])
    tmesh = make_mesh({"data": shards}, CPU8[:shards])
    return (
        JaxIndex(dim, metric=metric, capacity=capacity, mesh=jmesh),
        ShardedKnnIndex(dim, metric=metric, capacity=capacity, mesh=tmesh),
    )


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_sharded_index_matches_jax_through_updates_and_a_grow(metric):
    jidx, tidx = _pair(metric)
    assert (tidx.shards, tidx.capacity, tidx.shard_rows) == (jidx.shards, jidx.capacity, 128)
    q = _vecs(5, 9)
    # host rows, then encoder-style device rows with padding
    for idx, dev in ((jidx, jnp.asarray), (tidx, torch.from_numpy)):
        idx.add_batch([f"h{i}" for i in range(300)], _vecs(300, 1))
        pad = np.concatenate([_vecs(40, 2), _vecs(24, 3)])
        idx.add_batch_device([f"d{i}" for i in range(40)], dev(pad), n_valid=40)
    for k in (1, 10, 200):  # k=200 > shard_rows: kk = shard_rows per shard
        _same(jidx.search(q, k), tidx.search(q, k))
    # upserts (new vectors for live keys), removes, a miss
    for idx in (jidx, tidx):
        idx.add_batch([f"h{i}" for i in range(0, 300, 5)], _vecs(60, 4))
        idx.remove([f"h{i}" for i in range(1, 300, 7)] + ["d3", "missing"])
    _same(jidx.search(q, 10), tidx.search(q, 10))
    # a handle dispatched before a grow is collected after it
    hj, ht = jidx.dispatch(q, 10), tidx.dispatch(q, 10)
    before = tidx.search(q, 10)
    for idx in (jidx, tidx):
        idx.add_batch([f"g{i}" for i in range(800)], _vecs(800, 5))
    assert tidx.capacity == jidx.capacity == 2048 and tidx.shard_rows == 256
    got = tidx.collect(ht)
    _same(jidx.collect(hj), got)
    _same(before, got)  # the rows live at dispatch time
    _same(jidx.search(q, 300), tidx.search(q, 300))
    assert len(jidx) == len(tidx) and sorted(map(str, jidx.keys)) == sorted(map(str, tidx.keys))


def test_sharded_search_equals_the_unsharded_index():
    """The mesh changes where rows live, not the answers: a sharded and an
    unsharded port index over the same rows agree, and the per-shard
    search with offsets and the merge equals one search over the slab."""
    sharded = ShardedKnnIndex(DIM, capacity=1024, mesh=make_mesh({"data": 4}, CPU8[:4]))
    flat = ShardedKnnIndex(DIM, capacity=1024, device="cpu")
    for idx in (sharded, flat):
        idx.add_batch(range(900), _vecs(900, 1))
        idx.remove(range(0, 900, 11))
    q = _vecs(7, 2)
    for k in (5, 129, 300):
        _same(flat.search(q, k), sharded.search(q, k))
    torch.testing.assert_close(sharded._vectors, flat._vectors)
    torch.testing.assert_close(sharded._valid, flat._valid)
    qt = torch.nn.functional.normalize(torch.from_numpy(q), dim=1, eps=1e-12)
    rows = sharded.shard_rows
    parts = [knn_topk_plain(qt, sharded._vecs[s], sharded._flags[s], 50, "dot", offset=s * rows)
             for s in range(4)]
    mv, mi = merge_partials(torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1),
                            50, presorted=False)
    wv, wi = knn_topk_plain(qt, flat._vectors, flat._valid, 50, "dot")
    torch.testing.assert_close(mv, wv)
    assert torch.equal(mi, wi)


def test_sharded_state_crosses_both_ways_and_restores_invalidate_handles():
    jidx, tidx = _pair("cos")
    for idx in (jidx, tidx):
        idx.add_batch([f"k{i}" for i in range(500)], _vecs(500, 1))
        idx.remove([f"k{i}" for i in range(0, 500, 9)])
    q = _vecs(4, 3)
    want = jidx.search(q, 12)
    # JAX sharded -> port sharded, port sharded -> JAX sharded, port sharded -> port unsharded
    tstate, jstate = tidx.state_dict(), jidx.state_dict()
    np.testing.assert_allclose(tstate["vectors"], np.asarray(jstate["vectors"]), atol=1e-6)
    np.testing.assert_array_equal(tstate["valid"], np.asarray(jstate["valid"]))
    assert tstate["slot_of"] == jstate["slot_of"] and tstate["cursor"] == jstate["cursor"]
    t2 = ShardedKnnIndex(DIM, mesh=make_mesh({"data": 8}, CPU8))
    t2.load_state_dict(jstate)
    _same(want, t2.search(q, 12))
    j2 = JaxIndex(DIM, mesh=jax_make_mesh())
    j2.load_state_dict(tstate)
    _same(want, j2.search(q, 12))
    flat = ShardedKnnIndex(DIM, capacity=8, device="cpu")
    flat.load_state_dict(tstate)
    _same(want, flat.search(q, 12))
    # both keep working after the load, and a pre-restore handle raises
    stale = t2.dispatch(q, 3)
    t2.load_state_dict(jstate)
    with pytest.raises(RuntimeError, match="stale"):
        t2.collect(stale)
    for idx in (t2, j2):
        idx.add_batch(["new"], _vecs(1, 4))
    _same(j2.search(q, 12), t2.search(q, 12))


def test_small_capacity_rounds_to_shards_and_keeps_answers():
    """capacity 8 over 8 shards rounds up to 1,024 rows, 128 per shard."""
    jidx, tidx = _pair("dot", capacity=8)
    assert tidx.capacity == jidx.capacity == 1024
    items = [(f"x{i}", v) for i, v in enumerate(_vecs(3, 1))]
    jidx.add(items)
    tidx.add(items)
    _same(jidx.search(_vecs(2, 2), 5), tidx.search(_vecs(2, 2), 5))
    assert ShardedKnnIndex(DIM, capacity=8, mesh=make_mesh({"data": 8}, CPU8)).search(_vecs(1, 1), 3) == [[]]


# ---------------------------------------------------------------------------
# the data-parallel encoder


@pytest.fixture(scope="module")
def dp_pair():
    jcfg = graft._flagship_config(tiny=True)
    jenc = JittedEncoder(jcfg, max_batch=16, seed=0, mesh=jax_make_mesh({"data": 4}, jax.devices()[:4]))
    params = jax.tree.map(np.asarray, jenc.params)
    tenc = TorchEncoder(port_config(jcfg), max_batch=16, params=params,
                        mesh=make_mesh({"data": 4}, CPU8[:4]))
    return jenc, tenc


def test_dp_encoder_matches_jax(dp_pair):
    jenc, tenc = dp_pair
    texts = _texts(37, 2)  # chunks of 16, 16 and 5: the last padded to 8, two rows per part
    np.testing.assert_allclose(tenc.encode(texts), jenc.encode(texts), atol=ENC_TOL)
    ids, mask = np.ones((5, 16), np.int32), np.zeros((5, 16), np.int32)
    for enc in (jenc, tenc):
        _, m, _, n = enc._pad_batch(ids, mask.copy(), ids.copy())
        assert n == 5 and m.shape == (8, 16) and m[5:, 0].tolist() == [1] * 3
    # a degree that does not divide the bucket: 8 rows round up to 9
    jcfg = graft._flagship_config(tiny=True)
    j3 = JittedEncoder(jcfg, mesh=jax_make_mesh({"data": 3}, jax.devices()[:3]), params=jenc.params)
    t3 = TorchEncoder(port_config(jcfg), params=jax.tree.map(np.asarray, jenc.params),
                      mesh=make_mesh({"data": 3}, CPU8[:3]))
    for enc in (j3, t3):
        assert enc._pad_batch(ids, mask.copy(), ids.copy())[1].shape == (9, 16)
    np.testing.assert_allclose(t3.encode(texts[:5]), j3.encode(texts[:5]), atol=ENC_TOL)


@pytest.mark.parametrize("metric", ["cos", "dot"])
def test_dp_encode_into_a_sharded_index_matches_jax(dp_pair, metric):
    """The slice over the mesh: DP embed -> sharded index -> search."""
    jenc, tenc = dp_pair
    docs = _texts(50, 3)
    keys = [f"doc{i}" for i in range(50)]
    jidx, tidx = _pair(metric, capacity=128, shards=4, dim=64)
    assert jenc.encode_into(jidx, keys, docs) == tenc.encode_into(tidx, keys, docs) == 50
    jidx.remove(keys[::7])
    tidx.remove(keys[::7])
    want = jidx.search(jenc.encode(docs[:16]), 5)
    got = tidx.search(tenc.encode(docs[:16]), 5)
    _same(want, got, ENC_TOL)
    for i, row in enumerate(got):
        if i % 7:
            assert row[0][0] == keys[i] and row[0][1] >= 0.999


# ---------------------------------------------------------------------------
# K13's plain version


@pytest.mark.parametrize("k", [129, 256, 1000, 3000])
def test_topk_select_plain_matches_lax_top_k(k):
    rng = np.random.default_rng(k)
    vals = rng.standard_normal((5, 3000)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals), k)
    got_v, got_i = topk_select(torch.from_numpy(vals), k)  # CPU tensors: the plain version
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    ids = rng.integers(0, 2**31 - 1, vals.shape).astype(np.int32)
    v2, i2 = topk_select_plain(torch.from_numpy(vals), k, torch.from_numpy(ids))
    np.testing.assert_array_equal(i2.numpy(), np.take_along_axis(ids, np.asarray(want_i), 1))
    _, i3 = topk_select_plain(torch.from_numpy(vals), k, offset=4096)
    np.testing.assert_array_equal(i3.numpy(), np.asarray(want_i) + 4096)
    with pytest.raises(ValueError, match="k="):
        topk_select(torch.from_numpy(vals), 3001)


def _edge_scores(kind, rng):
    """[5, 3000] rows for K13's edge cases."""
    shape = (5, 3000)
    if kind == "ties":  # few distinct values: ties at and around the k-th
        return np.round(rng.standard_normal(shape), 1).astype(np.float32)
    if kind == "signed_zeros":  # +0 and -0 tie, among ones and minus ones
        vals = np.where(rng.random(shape) < 0.5, np.float32(-0.0), np.float32(0.0))
        vals[rng.random(shape) < 0.02] = 1.0
        vals[rng.random(shape) < 0.02] = -1.0
        return vals.astype(np.float32)
    if kind == "masked":  # NEG_INF-masked slots, fewer live than k
        vals = np.full(shape, NEG_INF, np.float32)
        live = rng.random(shape) < 0.02
        vals[live] = rng.standard_normal(int(live.sum()))
        return vals
    if kind == "all_equal":
        return np.full(shape, 0.25, np.float32)
    return np.tile(np.arange(shape[1], dtype=np.float32), (shape[0], 1))  # ascending


@pytest.mark.parametrize("kind", ["ties", "signed_zeros", "masked", "all_equal", "ascending"])
@pytest.mark.parametrize("k", [129, 1000, 3000])
def test_topk_select_plain_ties_zeros_and_masks_match_lax_top_k(kind, k):
    vals = _edge_scores(kind, np.random.default_rng(k))
    # lax.top_k orders -0 below +0 (a total order); the port ranks them
    # together, as the float comparison does, ties to the lower position
    # (a deliberate deviation, ROADMAP C §5): lax.top_k of the same rows
    # with -0 made +0
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals + np.float32(0.0)), k)
    got_v, got_i = topk_select(torch.from_numpy(vals), k)  # CPU tensors: the plain version
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    raw_v, raw_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(vals), k))
    got_zeros = got_v.numpy()[got_v.numpy() == 0]
    if np.signbit(got_zeros).any():
        # on the raw rows lax.top_k puts every +0 above every -0, so its
        # order differs from the port's; the values compare equal
        assert all(np.all(np.diff(np.signbit(row[row == 0]).astype(int)) >= 0) for row in raw_v)
        assert not np.array_equal(raw_i, got_i.numpy())
        assert (raw_v == got_v.numpy()).all()
    else:  # no -0 among the winners: the raw rows give the same order
        np.testing.assert_array_equal(raw_i, got_i.numpy())
    # each value comes back as stored, sign of zero included
    np.testing.assert_array_equal(
        np.signbit(got_v.numpy()), np.signbit(np.take_along_axis(vals, got_i.numpy().astype(np.int64), 1))
    )


def test_select_plan_grid_slots_and_int32_limits():
    # the path's shape: 32 rows of 1M scores spread over ~528 blocks; the
    # k-th best's bin is sorted with the winners in 4,096 slots
    p = select_plan(32, 1 << 20, 256)
    assert p["slots"] == 4096 and p["chunk"] % 4 == 0
    assert (p["splits"] - 1) * p["chunk"] < 1 << 20 <= p["splits"] * p["chunk"]
    assert 528 <= 32 * p["splits"] < 528 + 32
    assert p["scratch_i"] == 32 * (2048 + 16 + 4096 + p["splits"]) and p["scratch_f"] == 32 * 4096
    # short rows: one chunk, slots down to the row's power of two
    assert select_plan(32, 2048, 256) == {
        "slots": 2048, "splits": 1, "chunk": 2048, "scratch_i": 32 * (2048 + 16 + 2048 + 1),
        "scratch_f": 32 * 2048,
    }
    assert select_plan(1, 10, 10)["slots"] == 16 and select_plan(1, 10, 10)["chunk"] == 12
    # k above 4,096 (and k = n): slots the power of two of k
    assert select_plan(2, 100_000, 5000)["slots"] == 8192
    assert select_plan(1, 3000, 3000)["slots"] == 4096
    # int32 positions and the grid's rows
    assert select_plan(MAX_ROWS, 10, 1)["splits"] == 1
    big = select_plan(1, MAX_LEN, 1)
    assert big["splits"] * big["chunk"] >= MAX_LEN and MAX_LEN + 4096 < 2**31
    assert select_plan(1, MAX_LEN, MAX_SLOTS)["slots"] == MAX_SLOTS
    with pytest.raises(ValueError, match="slots"):
        select_plan(1, MAX_LEN, MAX_SLOTS + 1)
    with pytest.raises(ValueError, match="int32 positions or grid"):
        select_plan(MAX_ROWS + 1, 10, 1)
    with pytest.raises(ValueError, match="int32 positions or grid"):
        select_plan(1, MAX_LEN + 1, 1)
    for k in (0, 11):
        with pytest.raises(ValueError, match="k="):
            select_plan(1, 10, k)
