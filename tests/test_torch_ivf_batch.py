"""Batch IVF search and the launch path of the port's kernels, on the CPU.

The IVF search at nq=32 with nprobe = nlist / 2, where every probed cell is
shared by many queries (the shape K12's cell-major form takes on a card),
against the JAX index's ``search`` and ``_search_jit`` with the tolerances
of ``tests/test_torch_ivf.py``'s P6/P7: scores 1e-5 (f32 sums of 16
products in another order), key sets equal away from k-th/(k+1)-th ties
within 1e-6; the same at nq=1,024 with every cell probed by every query,
more pairs a cell than a cell-major block buffers at once.  The pure
function that picks K12's form by nq, on both sides of its constant, and
the wrapper's use of the library's cell-major plan (the library stubbed:
it is built only on a card).  K16 with
act none on CPU tensors against ``jax.vjp`` of the bias add (db within 1e-5
of its largest value: an f32 sum of 96 rows in another order), and the
blocks its ``db`` rows come from on a card (made here on the CPU).  The
shared launch helper's device switch and stream handle, with the CUDA
calls it makes stubbed.
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pathway_tpu.parallel import IvfKnnIndex as JaxIvf
from pathway_tpu_torch.kernels import _launch, bias_act_bwd, ivf_scan, knn_topk_plain
from pathway_tpu_torch.kernels.ivf_scan import CELL_MAJOR_MIN_QUERIES, scan_form
from pathway_tpu_torch.parallel import IvfKnnIndex

SCORE_TOL = 1e-5
TIE = 1e-6
NQ = 32
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small products run faster on one thread, and leave the other cores
    to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mixture(n, d, n_clusters=10, seed=0):
    """``tests/test_ivf.py``'s clustered data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)


def _pair(dtype, metric, nlist=16):
    jd, td = _DT[dtype]
    kw = dict(metric=metric, capacity=1024, nlist=nlist, nprobe=nlist // 2)
    return JaxIvf(16, dtype=jd, **kw), IvfKnnIndex(16, dtype=td, device="cpu", **kw)


def _filled(dtype, metric):
    jidx, tidx = _pair(dtype, metric)
    # scores of order 1 (an exact power-of-two scale), where f32 sums in
    # another order stay within SCORE_TOL
    x = _mixture(1200, 16, seed=3) * 0.125
    for idx in (jidx, tidx):
        idx.add_batch(range(1200), x)  # auto-trains at 1,024
        idx.remove(list(range(0, 1200, 3)))  # 800 live rows
    return jidx, tidx


def _same_topk(jrows, trows, jnext):
    assert len(jrows) == len(trows) == NQ
    for jr, tr, nx in zip(jrows, trows, jnext):
        assert len(jr) == len(tr)
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr], atol=SCORE_TOL, rtol=0)
        if len(nx) > len(jr) and abs(nx[len(jr)][1] - jr[-1][1]) <= TIE:
            continue
        assert {k for k, _ in tr} == {k for k, _ in jr}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("metric", ["cos", "dot"])
@pytest.mark.parametrize("k", [10, 200])
def test_batch_search_matches_jax(dtype, metric, k):
    """32 queries, each probing half of the 16 cells: every probed cell is
    shared by several queries.  k=200 passes MAX_K (the score-only scan and
    K13 on a card) and the live rows some queries' probed cells hold."""
    jidx, tidx = _filled(dtype, metric)
    q = _mixture(NQ, 16, seed=11) * 0.125
    assert scan_form(NQ) == "cell"
    jrows = jidx.search(q, k)
    _same_topk(jrows, tidx.search(q, k), jidx.search(q, k + 1))
    assert all(len(r) == k for r in jrows) if k == 10 else all(jrows)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_batch_raw_scan_matches_the_jax_program(dtype):
    """``_search_jit``'s raw ``(vals, flat ids)`` for 32 queries against K3's
    plain probe and the scan over the same cells; the probe shares each
    probed cell among 16 queries on average."""
    jidx, _ = _filled(dtype, "cos")
    q = jidx._normalize(_mixture(NQ, 16, seed=12))
    k, nprobe = 12, 8
    jv, ji = jidx._search_jit(k, nprobe)(jnp.asarray(q), jidx._centroids, jidx._cells, jidx._valid)
    jv, ji = np.asarray(jv), np.asarray(ji)

    tq = torch.from_numpy(q)
    cents = torch.from_numpy(np.array(jidx._centroids))
    cells = torch.from_numpy(np.array(jidx._cells, np.float32)).to(_DT[dtype][1])
    valid = torch.from_numpy(np.array(jidx._valid))
    probe = knn_topk_plain(tq, cents, torch.ones(16), nprobe, "dot")[1]
    shared = np.bincount(probe.numpy().ravel(), minlength=16)
    assert shared.max() >= NQ // 2 and (shared > 1).sum() >= nprobe
    tv, ti = ivf_scan(tq, probe, cells, valid, k)
    np.testing.assert_allclose(tv.numpy(), jv, atol=SCORE_TOL, rtol=0)
    for r in range(NQ):
        sure = jv[r] > jv[r, -1] + TIE  # clear of the k-th score
        assert set(ji[r][sure]) <= set(ti[r].numpy())


@pytest.mark.parametrize(
    "nq,form",
    [(1, "query"), (CELL_MAJOR_MIN_QUERIES - 1, "query"), (CELL_MAJOR_MIN_QUERIES, "cell"),
     (CELL_MAJOR_MIN_QUERIES + 1, "cell"), (64, "cell"), (1024, "cell")],
)
def test_scan_form_by_query_count(nq, form):
    assert 1 < CELL_MAJOR_MIN_QUERIES <= 64
    assert scan_form(nq) == form


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("metric", ["cos", "dot"])
def test_large_batch_probing_every_cell_matches_jax(dtype, metric):
    """1,024 queries with nprobe = nlist: each cell is probed by 1,024
    (query, probe rank) pairs, past the 512 a cell-major block buffers."""
    jidx, tidx = _filled(dtype, metric)
    q = _mixture(1024, 16, seed=13) * 0.125
    jrows = jidx.search(q, 5, nprobe=16)
    trows = tidx.search(q, 5, nprobe=16)
    jnext = jidx.search(q, 6, nprobe=16)
    assert scan_form(len(q)) == "cell" and all(len(r) == 5 for r in jrows)
    for lo in range(0, 1024, NQ):
        _same_topk(jrows[lo : lo + NQ], trows[lo : lo + NQ], jnext[lo : lo + NQ])


class _Library:
    """The ``ivf_scan`` library stand-in: its plan returns ``groups`` and
    sizes the scratch as ``pw_ivf_scan_cells_plan`` documents it."""

    def __init__(self, groups):
        self.groups, self.plans = groups, []

    def pw_ivf_scan_cells_plan(self, d, bf16, k, nlist, cap, entries, scratch):
        self.plans.append((d, bf16, k, nlist, cap, entries))
        if self.groups:
            scratch[0], scratch[1] = entries * 4 * k, (nlist + 1) * 3
        return self.groups

    def pw_ivf_scan_cells(self, *args):
        return 0

    def pw_ivf_scan(self, *args):
        return 0


@pytest.fixture
def scan_calls(monkeypatch):
    """K12's module with its library, launch helper, merge and K13
    stubbed; returns the launches it made (function name, arguments)."""
    mod = importlib.import_module("pathway_tpu_torch.kernels.ivf_scan")
    calls = []
    monkeypatch.setattr(mod, "launch", lambda name, fn, device, *args: calls.append((fn.__name__, args)))
    monkeypatch.setattr(mod, "merge_partials", lambda vals, idx, k: ("merged", vals.shape, k))
    monkeypatch.setattr(mod, "topk_select", lambda vals, k, idx: ("selected", vals.shape, k))
    return mod, calls


def _scan_args(nq=32, nprobe=4, nlist=8, cap=64, d=16, probe_offset=0):
    probe = torch.zeros(nq * nprobe + probe_offset, dtype=torch.int32)[probe_offset:].view(nq, nprobe)
    return (torch.zeros((nq, d)), probe, torch.zeros((nlist, cap, d), dtype=torch.bfloat16),
            torch.zeros((nlist, cap)))


@pytest.mark.parametrize("groups", [16, 8])
def test_cell_major_scratch_comes_from_the_library_plan(scan_calls, monkeypatch, groups):
    mod, calls = scan_calls
    lib = _Library(groups)
    monkeypatch.setattr(mod, "_build", types.SimpleNamespace(library=lambda name: lib))
    qr, probe, cells, valid = _scan_args()
    out = mod._launch(qr, probe, cells, valid, 10, True, torch.device("cpu"))
    assert lib.plans == [(16, 1, 10, 8, 64, 128)]
    ((fn, args),) = calls
    assert fn == "pw_ivf_scan_cells" and args[9:] == (32, 4, 16, 8, 64, 10, 1)
    assert out == ("merged", (32, 40), 10)


def test_cell_major_form_falls_back_where_the_plan_refuses(scan_calls, monkeypatch):
    mod, calls = scan_calls
    lib = _Library(0)
    monkeypatch.setattr(mod, "_build", types.SimpleNamespace(library=lambda name: lib))
    out = mod._launch(*_scan_args(), 10, True, torch.device("cpu"))
    assert len(lib.plans) == 1 and [fn for fn, _ in calls] == ["pw_ivf_scan"]
    assert out[0] == "merged"


@pytest.mark.parametrize("cell_major,probe_offset", [(False, 0), (True, 1)])
def test_query_major_form_without_asking_the_plan(scan_calls, monkeypatch, cell_major, probe_offset):
    """Asked for the query-major form, or with a probe not 16 bytes aligned,
    the wrapper launches ``pw_ivf_scan`` and never asks for a plan."""
    mod, calls = scan_calls
    lib = _Library(16)
    monkeypatch.setattr(mod, "_build", types.SimpleNamespace(library=lambda name: lib))
    qr, probe, cells, valid = _scan_args(probe_offset=probe_offset)
    assert (probe.data_ptr() % 16 == 0) != bool(probe_offset)
    mod._launch(qr, probe, cells, valid, 10, cell_major, torch.device("cpu"))
    assert lib.plans == [] and [fn for fn, _ in calls] == ["pw_ivf_scan"]


def test_score_only_scan_past_max_k(scan_calls, monkeypatch):
    mod, calls = scan_calls
    lib = _Library(0)
    monkeypatch.setattr(mod, "_build", types.SimpleNamespace(library=lambda name: lib))
    out = mod._launch(*_scan_args(), 200, True, torch.device("cpu"))
    ((fn, args),) = calls
    assert fn == "pw_ivf_scan" and args[-2:] == (0, 1)  # kept = 0, bf16
    assert out == ("selected", (32, 4 * 64), 200)


@pytest.mark.parametrize("shape", [(96, 48), (4, 24, 48)])
def test_bias_act_bwd_none_matches_jax_vjp(shape):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, b_: x_ + b_, jnp.asarray(x), jnp.asarray(b))
    jdx, jdb = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dy = torch.from_numpy(g)
    dx, db = bias_act_bwd(dy, None, torch.from_numpy(b), "none")
    assert dx is dy
    np.testing.assert_array_equal(dx.numpy(), jdx)
    np.testing.assert_allclose(db.numpy(), jdb, atol=1e-5 * np.abs(jdb).max(), rtol=0)


def test_bias_act_bwd_none_raises_off_the_cpu_without_a_card():
    """A ``meta`` tensor is neither on the CPU nor on a card: act none
    raises as the activations do, and runs no plain version."""
    meta = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bias_act_bwd(meta, None, torch.empty((16,), device="meta"), "none")


def test_bias_sum_rows_are_handed_out_once_a_block_per_stream(monkeypatch):
    """Act none's ``db``: each call gets a row of its own, ``_DB_ROWS`` rows
    to a block, a new block once they are spent, and blocks apart for each
    stream and width."""
    bias_act_mod = importlib.import_module("pathway_tpu_torch.kernels.bias_act")  # the package's name is the function
    stream = {"handle": 7}
    monkeypatch.setattr(_launch, "_raw_stream", lambda index: stream["handle"])
    monkeypatch.setattr(bias_act_mod, "_db_rows", {})
    cpu = torch.device("cpu")
    rows = [bias_act_mod._db_row(cpu, 16) for _ in range(bias_act_mod._DB_ROWS + 1)]
    assert all(r.shape == (16,) and r.dtype == torch.float32 and r.is_contiguous() for r in rows)
    starts = {r.data_ptr() for r in rows}
    assert len(starts) == len(rows)  # no row handed out twice
    blocks = [{r.untyped_storage().data_ptr() for r in rows[:-1]}, {rows[-1].untyped_storage().data_ptr()}]
    assert len(blocks[0]) == 1 and blocks[0] != blocks[1]  # 64 rows from one block, then a new one
    stream["handle"] = 8
    other = bias_act_mod._db_row(cpu, 16)
    wide = bias_act_mod._db_row(cpu, 24)
    held = {p for b in blocks for p in b}
    assert other.untyped_storage().data_ptr() not in held and wide.shape == (24,)
    assert set(bias_act_mod._db_rows) == {(None, 7, 16), (None, 8, 16), (None, 8, 24)}


class _Switch:
    """``torch.cuda.device`` stand-in: records the devices it enters."""

    entered: list = []

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        _Switch.entered.append(self.index)

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_cuda(monkeypatch):
    """Card 1 current; each card's current stream handle is 1000 + its
    index (the helper's two getters stubbed)."""
    _Switch.entered = []
    monkeypatch.setattr(_launch, "_current_device", lambda: 1)
    monkeypatch.setattr(_launch, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "device", _Switch)
    return _Switch


def test_launch_switches_the_device_only_when_it_is_not_current(fake_cuda):
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    _launch.launch("k", fn, torch.device("cuda", 1), 5, 6)
    assert calls == [(5, 6, 1001)] and fake_cuda.entered == []
    _launch.launch("k", fn, torch.device("cuda", 3), 7)
    assert calls[-1] == (7, 1003) and fake_cuda.entered == [3]
    assert _launch.stream_of(torch.device("cuda", 2)) == 1002


def test_launch_raises_on_a_cuda_error(fake_cuda):
    with pytest.raises(RuntimeError, match="cudaError_t 98"):
        _launch.launch("k", lambda *args: 98, torch.device("cuda", 1))
