"""The port's ``IvfKnnIndex`` and its kernels' plain versions against the
JAX package's IVF index, on the CPU.

Each parity case of the port (P1-P9) runs the JAX ``IvfKnnIndex`` and the
port's (``device="cpu"``) on the same seeded numpy data.  Tolerances:
centroids 1e-6 (the same numpy mean over the same members; the f32 sums
that pick the members run in another order, so the data keep every
assignment margin above 1e-4); scores 1e-5 (f32 sums of at most 64
products in another order); stored cells bit for bit (the same f32 ->
bf16 rounding to nearest even).  Top-k key sets are compared except where
the k-th and (k+1)-th scores tie within 1e-6, where only the scores are.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pathway_tpu.parallel import IvfKnnIndex as JaxIvf
from pathway_tpu.parallel import ivf_knn as jax_ivf
from pathway_tpu_torch.kernels import (
    ivf_assign,
    ivf_assign_plain,
    ivf_scan,
    ivf_scan_plain,
    knn_topk_plain,
    slab_clear,
    slab_scatter,
)
from pathway_tpu_torch.parallel import IvfKnnIndex, ShardedKnnIndex
from pathway_tpu_torch.parallel import ivf_knn as port_ivf

SCORE_TOL = 1e-5
CENT_TOL = 1e-6
MARGIN = 1e-4
TIE = 1e-6
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _mixture(n, d, n_clusters=64, seed=0):
    """``tests/test_ivf.py``'s clustered data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def _pair(d, dtype="bf16", **kw):
    jd, td = _DT[dtype]
    return JaxIvf(d, dtype=jd, **kw), IvfKnnIndex(d, dtype=td, device="cpu", **kw)


def _both(jidx, tidx, method, *args):
    getattr(jidx, method)(*args)
    getattr(tidx, method)(*args)


def _plain_assign(data, record=None):
    """The port's Lloyd assignment on the CPU, noting each step's smallest
    top-2 margin (in f64) in ``record``."""
    x = torch.from_numpy(data)

    def assign(cents):
        if record is not None:
            s = data.astype(np.float64) @ cents.T.astype(np.float64)
            s -= 0.5 * (cents.astype(np.float64) ** 2).sum(1)
            top2 = np.sort(s, axis=1)[:, -2:]
            record.append(float((top2[:, 1] - top2[:, 0]).min()))
        return ivf_assign(x, torch.from_numpy(cents), half_norm=True).numpy()

    return assign


# ---------------------------------------------------------------------------
# P1: the random draws of k-means and of train's subsample


@jax.jit
def _jax_lloyd_assign(x, c):
    """``_kmeans.assign`` of the JAX package, the same program."""
    scores = x @ c.T - 0.5 * jnp.sum(c * c, axis=1)[None, :]
    return jnp.argmax(scores, axis=1)


@pytest.mark.parametrize(
    "n,nlist",
    [(300, 16), (10, 16), (40, 8)],
    ids=["sample", "fewer-points-than-cells", "dead-cells"],
)
def test_p1_kmeans_draws_match_jax(n, nlist):
    """The initial choice, the degenerate ``normal`` fill and the dead-cell
    re-seeds come from the same numpy generator in the same order: given
    the JAX program's own assignments, the port's host loop gives the JAX
    centroids bit for bit.  The dead-cell case puts 40 rows on 4 points,
    so 8 centroids drawn from them leave cells empty."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(n, 8)).astype(np.float32)
    if nlist == 8:
        data = np.repeat(data[:4], 10, axis=0)
    xd = jnp.asarray(data)
    used: list[int] = []

    def assign(cents):
        a = np.asarray(_jax_lloyd_assign(xd, jnp.asarray(cents)))
        used.append(len(np.unique(a)))
        return a

    want = jax_ivf._kmeans(data, nlist, seed=3)
    got = port_ivf._kmeans(data, nlist, assign, seed=3)
    assert got.dtype == np.float32 and got.shape == (nlist, 8)
    if nlist == 8:
        assert min(used) < nlist  # some cell was empty, so re-seeded by a draw
    np.testing.assert_array_equal(got, want)


def test_p1_train_subsample_draws_match_jax():
    """``train`` subsamples a sample larger than ``train_size`` with its own
    generator before k-means draws."""
    x = _mixture(600, 16, n_clusters=8, seed=2)
    jidx, tidx = _pair(16, metric="cos", capacity=1024, nlist=8, nprobe=8, train_size=250)
    _both(jidx, tidx, "train", x)
    np.testing.assert_allclose(tidx.state_dict()["centroids"], np.asarray(jidx._centroids),
                               atol=CENT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# P2: the centroid update


def test_p2_centroid_update_matches_jax_away_from_ties():
    data = _mixture(400, 16, n_clusters=6, seed=7)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    margins: list[float] = []
    got = port_ivf._kmeans(data, 6, _plain_assign(data, margins), seed=0)
    want = jax_ivf._kmeans(data, 6, seed=0)
    assert len(margins) == 8 and min(margins) > MARGIN, margins
    np.testing.assert_allclose(got, want, atol=CENT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# P3/P4/P5: host steps, slot bookkeeping and stored rows after the
# scenarios of tests/test_ivf.py


def _upsert_remove_auto_train(dtype):
    jidx, tidx = _pair(16, dtype, metric="cos", capacity=4096, nlist=16, nprobe=16)
    x = np.random.default_rng(0).normal(size=(2000, 16)).astype(np.float32)
    _both(jidx, tidx, "add_batch", range(2000), x)  # buffers, then auto-trains
    _both(jidx, tidx, "add_batch", [0], x[1][None, :])
    _both(jidx, tidx, "remove", [0, 1, "never-added"])
    return jidx, tidx


def _grow(dtype):
    jidx, tidx = _pair(8, dtype, metric="dot", capacity=64, nlist=16, nprobe=16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8)).astype(np.float32) + 0.01 * rng.normal(size=(3000, 8)).astype(np.float32)
    _both(jidx, tidx, "train", x[:500])
    _both(jidx, tidx, "add_batch", range(3000), x)
    _both(jidx, tidx, "add_batch", ["outlier"], (100.0 * np.eye(1, 8)).astype(np.float32))
    assert jidx.cell_cap == tidx.cell_cap > 64
    return jidx, tidx


def _duplicate_key(dtype):
    jidx, tidx = _pair(8, dtype, metric="cos", capacity=256, nlist=4, nprobe=4)
    x = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
    _both(jidx, tidx, "train", x)
    _both(jidx, tidx, "add_batch", ["k", "k", "j"], x[:3])
    _both(jidx, tidx, "remove", ["k"])
    _both(jidx, tidx, "add", [("k", x[5]), ("m", x[6])])
    return jidx, tidx


def _retrain(dtype):
    """Rows buffered, trained, then re-trained on another sample: the
    stored bf16 rows are read back as f32 and re-added."""
    jidx, tidx = _pair(16, dtype, metric="cos", capacity=2048, nlist=16, nprobe=4)
    x = _mixture(1500, 16, n_clusters=12, seed=4)
    _both(jidx, tidx, "add_batch", [f"r{i}" for i in range(300)], x[:300])
    _both(jidx, tidx, "train", None)
    _both(jidx, tidx, "add_batch", [f"r{i}" for i in range(300, 1500)], x[300:])
    _both(jidx, tidx, "remove", [f"r{i}" for i in range(0, 1500, 7)])
    _both(jidx, tidx, "train", x[::3] * 5.0)
    return jidx, tidx


SCENARIOS = {
    "upsert-remove-auto-train": _upsert_remove_auto_train,
    "grow": _grow,
    "duplicate-key": _duplicate_key,
    "retrain": _retrain,
}


def test_p3_double_normalisation_matches_jax():
    """``add_batch`` normalises (eps 1e-30) and buffers, ``train`` normalises
    the buffered rows again; rows of every scale, a zero row and a row of
    norm 1e-25 end up as the same cells and centroids."""
    jidx, tidx = _pair(16, "bf16", metric="cos", capacity=4096, nlist=16, nprobe=16)
    rng = np.random.default_rng(11)
    x = _mixture(1100, 16, n_clusters=16, seed=11)
    x *= np.exp(rng.uniform(-8, 8, size=(1100, 1))).astype(np.float32)
    x[3] = 0.0
    x[4] = 1e-25 * x[5] / np.linalg.norm(x[5])
    _both(jidx, tidx, "add_batch", range(600), x[:600])
    assert not jidx.trained and not tidx.trained
    np.testing.assert_array_equal(
        np.stack([v for _, v in tidx._pending]), np.stack([v for _, v in jidx._pending])
    )
    _both(jidx, tidx, "add_batch", range(600, 1100), x[600:])  # auto-trains at 1,024
    assert jidx.trained and tidx.trained
    js, ts = jidx.state_dict(), tidx.state_dict()
    np.testing.assert_allclose(ts["centroids"], js["centroids"], atol=CENT_TOL, rtol=0)
    np.testing.assert_array_equal(ts["cells"], np.asarray(js["cells"], np.float32))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_p4_slot_bookkeeping_state_matches_jax(scenario):
    jidx, tidx = SCENARIOS[scenario]("bf16")
    js, ts = jidx.state_dict(), tidx.state_dict()
    assert ts["slot_of"] == js["slot_of"]
    np.testing.assert_array_equal(ts["cursor"], js["cursor"])
    assert ts["free"] == js["free"]
    assert ts["cell_cap"] == js["cell_cap"] and ts["nlist"] == js["nlist"]
    assert [k for k, _ in ts["pending"]] == [k for k, _ in js["pending"]]
    np.testing.assert_array_equal(ts["valid"], js["valid"])
    assert len(tidx) == len(jidx) and tidx.keys() == jidx.keys()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_p5_stored_cells_bit_equal(scenario, dtype):
    jidx, tidx = SCENARIOS[scenario](dtype)
    assert tidx._cells.dtype == _DT[dtype][1]
    got = tidx._cells.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(jidx._cells, np.float32))


# ---------------------------------------------------------------------------
# P6/P7: search


def _same_topk(jrows, trows, jnext):
    """Scores within SCORE_TOL; key sets equal unless the k-th and the
    (k+1)-th score (``jnext``: the JAX answer with k+1) tie within TIE."""
    assert len(jrows) == len(trows)
    for jr, tr, nx in zip(jrows, trows, jnext):
        assert len(jr) == len(tr)
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr], atol=SCORE_TOL, rtol=0)
        if len(nx) > len(jr) and abs(nx[len(jr)][1] - jr[-1][1]) <= TIE:
            continue
        assert {k for k, _ in tr} == {k for k, _ in jr}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("metric", ["cos", "dot"])
@pytest.mark.parametrize(
    "nprobe,k",
    [(3, 10), (16, 10), (16, 900), (1, 300)],
    ids=["nprobe<nlist", "nprobe=nlist", "k>live", "k>nprobe*cap"],
)
def test_p6_search_matches_jax(metric, dtype, nprobe, k):
    jidx, tidx = _pair(16, dtype, metric=metric, capacity=1024, nlist=16, nprobe=4)
    # scores of order 1 (an exact power-of-two scale), where f32 sums in
    # another order stay within SCORE_TOL
    x = _mixture(1200, 16, n_clusters=10, seed=3) * 0.125
    _both(jidx, tidx, "add_batch", range(1200), x)  # auto-trains at 1,024
    _both(jidx, tidx, "remove", list(range(0, 1200, 2)))  # 600 live rows
    q = _mixture(6, 16, n_clusters=10, seed=8) * 0.125
    jrows = jidx.search(q, k, nprobe=nprobe)
    _same_topk(jrows, tidx.search(q, k, nprobe=nprobe), jidx.search(q, k + 1, nprobe=nprobe))
    if k == 900:
        assert all(len(r) == 600 for r in jrows)  # the sentinels are dropped
    if k == 300:  # k_eff = min(k, nprobe * cell_cap) = 256 slots of one cell
        assert tidx.cell_cap == 256 and all(len(r) <= 256 for r in jrows)


def test_p6_nprobe_is_capped_at_nlist():
    jidx, tidx = _pair(16, "f32", metric="cos", capacity=1024, nlist=16)
    x = _mixture(1100, 16, n_clusters=10, seed=3)
    _both(jidx, tidx, "add_batch", range(1100), x)
    q = x[:4]
    _same_topk(jidx.search(q, 5, nprobe=40), tidx.search(q, 5, nprobe=40), jidx.search(q, 6, nprobe=40))
    assert [r[0][0] for r in tidx.search(q, 1, nprobe=40)] == [0, 1, 2, 3]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_p7_plain_probe_and_scan_match_the_jax_program(dtype):
    """``_search_jit``'s raw ``(vals, flat ids)`` on queries padded to a
    multiple of ``query_block``, against K3's plain probe and
    ``ivf_scan_plain`` over the same cells."""
    jidx, _ = _pair(16, dtype, metric="cos", capacity=1024, nlist=16)
    x = _mixture(1100, 16, n_clusters=10, seed=6)
    jidx.add_batch(range(1100), x)
    jidx.remove(list(range(0, 1100, 3)))
    q = jidx._normalize(_mixture(11, 16, n_clusters=10, seed=9))
    k, nprobe = 12, 5
    qpad = np.concatenate([q, np.zeros((5, 16), np.float32)])  # 16 = 2 blocks of 8
    jv, ji = jidx._search_jit(k, nprobe)(jnp.asarray(qpad), jidx._centroids, jidx._cells, jidx._valid)
    jv, ji = np.asarray(jv)[:11], np.asarray(ji)[:11]

    tq = torch.from_numpy(q)
    cents = torch.from_numpy(np.array(jidx._centroids))
    cells = torch.from_numpy(np.array(jidx._cells, np.float32)).to(_DT[dtype][1])
    valid = torch.from_numpy(np.array(jidx._valid))
    probe = knn_topk_plain(tq, cents, torch.ones(16), nprobe, "dot")[1]
    tv, ti = ivf_scan_plain(tq, probe, cells, valid, k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), jv, atol=SCORE_TOL, rtol=0)
    for r in range(11):
        sure = jv[r] > jv[r, -1] + TIE  # clear of the k-th score
        assert set(ji[r][sure]) <= set(ti[r].numpy())
    # the wrapper on CPU tensors is the plain version, block size aside
    wv, wi = ivf_scan(tq, probe, cells, valid, k, query_block=3)
    torch.testing.assert_close(wv, tv)


# ---------------------------------------------------------------------------
# P8: persistence


def test_p8_state_dict_round_trips_with_jax():
    jidx, _ = _retrain("bf16")
    q = _mixture(5, 16, n_clusters=12, seed=10)
    port = IvfKnnIndex(16, metric="cos", capacity=2048, nlist=16, nprobe=4, device="cpu")
    port.load_state_dict(jidx.state_dict())  # the bf16 cells of the JAX state
    assert port._cells.dtype == torch.bfloat16
    _same_topk(jidx.search(q, 8), port.search(q, 8), jidx.search(q, 9))

    state = port.state_dict()
    assert state["cells"].dtype == np.float32 and state["dtype"] == "bfloat16"
    again = IvfKnnIndex(16, metric="cos", capacity=64, nlist=16, nprobe=4, device="cpu")
    again.load_state_dict(state)
    assert again._cells.dtype == torch.bfloat16 and again.cell_cap == port.cell_cap
    _same_topk(jidx.search(q, 8), again.search(q, 8), jidx.search(q, 9))

    back = JaxIvf(16, metric="cos", capacity=2048, nlist=16, nprobe=4)
    back.load_state_dict(state)  # its cells are then f32
    assert back._cells.dtype == jnp.float32
    for rb, rp in zip(back.search(q, 8), port.search(q, 8)):
        assert {k for k, _ in rb} == {k for k, _ in rp}


def test_p8_cells_loaded_as_f32_round_later_rows_as_jax_does():
    """A bf16 index that loads an f32 state keeps f32 cells; rows added
    later are rounded to bf16 first, and a grow makes the cells bf16."""
    src, _ = _pair(8, "f32", metric="dot", capacity=256, nlist=4, nprobe=4)
    x = np.random.default_rng(1).normal(size=(200, 8)).astype(np.float32)
    src.train(x)
    src.add_batch(range(50), x[:50])
    jidx, tidx = _pair(8, "bf16", metric="dot", capacity=256, nlist=4, nprobe=4)
    _both(jidx, tidx, "load_state_dict", src.state_dict())
    assert tidx._cells.dtype == torch.float32 and tidx.dtype == torch.bfloat16
    _both(jidx, tidx, "add_batch", range(50, 200), x[50:])
    np.testing.assert_array_equal(tidx._cells.numpy(), np.asarray(jidx._cells, np.float32))
    _both(jidx, tidx, "add_batch", range(200, 1200), np.repeat(x[:1], 1000, axis=0))  # grows
    assert tidx.cell_cap == jidx.cell_cap > 256 // 4 * 4
    assert tidx._cells.dtype == torch.bfloat16
    np.testing.assert_array_equal(tidx._cells.float().numpy(), np.asarray(jidx._cells, np.float32))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_p8_state_dict_is_a_snapshot(dtype):
    """The state's arrays are copies, as the JAX index's are: later
    updates of the index leave them as they were."""
    _, tidx = _duplicate_key(dtype)
    state = tidx.state_dict()
    before = {f: state[f].copy() for f in ("cells", "valid", "centroids")}
    x = np.random.default_rng(2).normal(size=(40, 8)).astype(np.float32)
    tidx.add_batch([f"n{i}" for i in range(40)], x)
    tidx.remove(["j"])
    tidx.train(x)
    for f, arr in before.items():
        np.testing.assert_array_equal(state[f], arr)


# ---------------------------------------------------------------------------
# P9: metrics


def test_p9_only_cos_and_dot():
    with pytest.raises(ValueError, match="l2sq"):
        JaxIvf(8, metric="l2sq")
    with pytest.raises(ValueError, match="l2sq"):
        IvfKnnIndex(8, metric="l2sq", device="cpu")


# ---------------------------------------------------------------------------
# recall, the JAX package's contract (tests/test_ivf.py:21-40), at 20,000
# rows of 64


def test_recall_vs_brute_force():
    n, d, k = 20_000, 64, 10
    x = _mixture(n, d)
    queries = _mixture(200, d, seed=1)
    ivf = IvfKnnIndex(d, metric="cos", capacity=n, device="cpu")
    ivf.add_batch(range(n), x)
    ivf.train(x)
    bf = ShardedKnnIndex(d, metric="cos", capacity=n, device="cpu")
    bf.add_batch(range(n), x)
    hits = 0
    for g, w in zip(ivf.search(queries, k), bf.search(queries, k)):
        truth = {key for key, _ in w}
        hits += sum(1 for key, _ in g if key in truth)
    recall = hits / (len(queries) * k)
    assert recall >= 0.95, f"recall@{k} = {recall:.3f} < 0.95"


# ---------------------------------------------------------------------------
# the kernels' plain versions and wrappers


@pytest.mark.parametrize("half_norm", [False, True], ids=["_assign_ip", "_kmeans.assign"])
def test_ivf_assign_plain_matches_jax(half_norm):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    c = rng.normal(size=(40, 32)).astype(np.float32) * rng.uniform(0.5, 2.0, size=(40, 1)).astype(np.float32)
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    scores = xj @ cj.T
    if half_norm:  # the formula of _kmeans.assign
        scores = scores - 0.5 * jnp.sum(cj * cj, axis=1)[None, :]
        want = np.asarray(jnp.argmax(scores, axis=1))
    else:
        want = np.asarray(jax_ivf._assign_ip(xj, cj))
    s = np.sort(np.asarray(scores), axis=1)
    assert (s[:, -1] - s[:, -2]).min() > MARGIN
    got = ivf_assign(torch.from_numpy(x), torch.from_numpy(c), half_norm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ivf_assign_plain(torch.from_numpy(x), torch.from_numpy(c), half_norm).numpy(), want)


def test_ivf_assign_ties_go_to_the_lower_centroid():
    c = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    x = torch.tensor([[1.0, 1.0], [2.0, 0.0]])
    assert ivf_assign_plain(x, c, False).tolist() == [0, 0]
    assert ivf_assign_plain(x, c, True).tolist() == [0, 0]


def test_scatter_and_clear_drop_out_of_range_pairs():
    """B11 on the flat view: the JAX pad pair ``(nlist, cell_cap)`` and any
    other pair out of range maps to -1, which K2 drops as ``mode="drop"``."""
    idx = IvfKnnIndex(4, metric="dot", capacity=128, nlist=4, nprobe=4, device="cpu")
    cap = idx.cell_cap
    cells = np.array([0, 3, 4, -1, 2, 1, 3])
    slots = np.array([0, cap - 1, cap, 0, cap, -1, 5])
    flat = idx._flat_slots(cells, slots)
    assert flat.dtype == np.int32
    assert flat.tolist() == [0, 3 * cap + cap - 1, -1, -1, -1, -1, 3 * cap + 5]
    rows = torch.arange(28, dtype=torch.float32).view(7, 4) + 1.0
    slab, valid = idx._cells.view(-1, 4), idx._valid.view(-1)
    slab_scatter(slab, valid, torch.from_numpy(flat), rows, normalize=False)
    assert valid.nonzero().flatten().tolist() == [0, 3 * cap + 5, 3 * cap + cap - 1]
    torch.testing.assert_close(idx._cells[3, 5].float(), rows[6])
    assert int((idx._cells != 0).any(-1).sum()) == 3
    slab_clear(valid, torch.from_numpy(flat))
    assert valid.sum() == 0


def test_ivf_scan_plain_sentinels_and_bounds():
    cells = torch.zeros((3, 4, 8))
    cells[1, 2, 0] = 2.0
    valid = torch.zeros((3, 4))
    valid[1, 2] = 1.0
    q = torch.zeros((1, 8))
    q[0, 0] = 1.0
    vals, ids = ivf_scan(q, torch.tensor([[1, 0]], dtype=torch.int32), cells, valid, 3)
    assert vals[0, 0].item() == 2.0 and ids[0, 0].item() == 1 * 4 + 2
    assert (vals[0, 1:] <= -1.5e38).all()
    with pytest.raises(ValueError, match="k=9"):
        ivf_scan(q, torch.tensor([[1, 0]], dtype=torch.int32), cells, valid, 9)


def test_wrappers_raise_instead_of_falling_back():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ivf_assign(torch.zeros((4, 8), **meta), torch.zeros((2, 8), **meta), False)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_scan(torch.zeros((1, 8), **meta), torch.zeros((1, 2), dtype=torch.int32, **meta),
                 torch.zeros((3, 4, 8), **meta), torch.zeros((3, 4), **meta), 2)


def test_index_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IvfKnnIndex(8)


def test_empty_index_queries_and_keys():
    idx = IvfKnnIndex(8, metric="cos", capacity=256, nlist=4, nprobe=4, device="cpu")
    x = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    assert idx.search(x[:2], 3) == [[], []]
    idx.add_batch(["a", "b"], x[:2])  # buffered
    assert len(idx) == 2 and "a" in idx and idx.keys() == ["a", "b"] and not idx.trained
    assert idx.search(np.zeros((0, 8), np.float32), 3) == []
    rows = idx.search(x[:1], 5)  # trains on the buffer first
    assert idx.trained and [k for k, _ in rows[0]][0] == "a" and len(rows[0]) == 2


# ---------------------------------------------------------------------------
# C7: any width (cells and centroids stored 16 bytes apart,
# kernels/_pitch.py)


@pytest.mark.parametrize("d", [1536, 3072, 770])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ivf_checks_take_wide_and_unaligned_widths(d, dtype):
    from pathway_tpu_torch.kernels._pitch import pitched_zeros
    from pathway_tpu_torch.kernels.ivf_scan import check_ivf_scan

    cells = pitched_zeros((4, 32, d), dtype, "cpu")
    check_ivf_scan(torch.zeros((3, d)), torch.zeros((3, 2), dtype=torch.int32), cells, torch.ones((4, 32)))
    x = torch.from_numpy(_mixture(40, d, n_clusters=4))
    c = x[:4].clone()
    assert torch.equal(ivf_assign(x, c, True), ivf_assign_plain(x, c, True))
    with pytest.raises(ValueError, match="pitch"):
        check_ivf_scan(torch.zeros((3, d + 1)), torch.zeros((3, 2), dtype=torch.int32),
                       torch.zeros((4, 32, d + 1), dtype=dtype), torch.ones((4, 32)))


@pytest.mark.parametrize("d", [1536, 770])
def test_wide_ivf_index_matches_jax(d):
    jidx, tidx = _pair(d, "f32", metric="cos", capacity=1024, nlist=16, nprobe=4)
    x = _mixture(1100, d, n_clusters=10, seed=3) / np.sqrt(d)
    _both(jidx, tidx, "add_batch", range(1100), x)  # auto-trains at 1,024
    _both(jidx, tidx, "remove", list(range(0, 1100, 3)))
    q = x[1:7]
    _same_topk(jidx.search(q, 5), tidx.search(q, 5), jidx.search(q, 6))
    state = tidx.state_dict()
    assert state["cells"].shape[-1] == d and state["centroids"].shape == (16, d)
