"""The port's ``stdlib.indexing`` (ROADMAP item 14) against the JAX
package's, on the CPU.

Each ``DataIndex`` pipeline is written once, as a function of the package
module (``build(pw)``), and runs through ``pathway_tpu`` and through
``pathway_tpu_torch`` (whose device indexes get ``device="cpu"``); the
counterparts of ``tests/test_indexing.py``'s cases.  The replies are
compared per query: the same row ids, the same set of reply ids, and each
reply's score within the tolerance of its index: 1e-5 on an f32 slab, 2e-2
on the bf16 IVF cells or through the bf16-tolerant encoder, BM25 and RRF
scores equal.  The order among replies is not compared: near-ties may fall
another way (scores summed in another order).

``SegmentedIndex`` runs the sequences of ``tests/test_index_maintenance.py``
over the port's ``ShardedKnnIndex``, ``IvfKnnIndex`` and ``HnswIndex`` and
over the JAX package's, and each sequence must observe the same key sets
on both.  ``compile_filter`` is held to the JAX one on
``tests/test_indexing_filters.py``'s expressions.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.parallel import IvfKnnIndex as JaxIvf
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import ShardedKnnIndex as JaxSharded
from pathway_tpu.stdlib.indexing import filters as jfilters
from pathway_tpu.stdlib.indexing.hnsw import HnswIndex as JaxHnsw
from pathway_tpu.stdlib.indexing.segments import SegmentedIndex as JaxSegmented
from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder
from pathway_tpu_torch import kernels
from pathway_tpu_torch.parallel import IvfKnnIndex, ShardedKnnIndex
from pathway_tpu_torch.stdlib.indexing import filters as tfilters
from pathway_tpu_torch.stdlib.indexing.hnsw import HnswIndex
from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex
from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder
from test_torch_encoder import port_config

F32_TOL = 1e-5
BF16_TOL = 2e-2

D = 8
N_DOCS = 40
_rng = np.random.default_rng(7)
VECS = _rng.standard_normal((N_DOCS, D)).astype(np.float32)
QVECS = np.concatenate([VECS[[0, 5, 11, 23]] + 0.05 * _rng.standard_normal((4, D)).astype(np.float32),
                        _rng.standard_normal((3, D)).astype(np.float32)])
WORDS = ["apple", "pie", "recipe", "banana", "bread", "rocket", "engine", "lattice", "quantum", "fox",
         "dog", "lazy", "quick", "brown", "stream", "index"]
TEXTS = [" ".join(_rng.choice(WORDS, int(_rng.integers(2, 7)))) for _ in range(N_DOCS)]
QTEXTS = ["apple pie", "rocket engine lattice", "lazy dog", "stream index quick", "banana"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


def kw(pw) -> dict:
    """The device argument of the port's device indexes (the JAX package's
    take none)."""
    return {"device": "cpu"} if pw is tpw else {}


def vec(row) -> tuple:
    return tuple(float(x) for x in row)


def docs_table(pw):
    rows = [
        (f"d{i}", vec(VECS[i]), TEXTS[i], {"grp": i % 3, "path": f"/docs/d{i}.{'pdf' if i % 2 else 'txt'}"})
        for i in range(N_DOCS)
    ]
    return pw.debug.table_from_rows(pw.schema_from_types(name=str, vec=tuple, text=str, meta=dict), rows)


def queries_table(pw, with_k: bool = False):
    if with_k:
        rows = [(f"q{i}", vec(q), 1 + i % 4) for i, q in enumerate(QVECS)]
        return pw.debug.table_from_rows(pw.schema_from_types(qid=str, qvec=tuple, k=int), rows)
    rows = [(f"q{i}", vec(q)) for i, q in enumerate(QVECS)]
    return pw.debug.table_from_rows(pw.schema_from_types(qid=str, qvec=tuple), rows)


# ---------------------------------------------------------------------------
# DataIndex pipelines, each written once


def knn_as_of_now(pw):
    docs, q = docs_table(pw), queries_table(pw)
    index = pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, **kw(pw)).build_data_index(
        docs.vec, docs)
    return index.query_as_of_now(q.qvec, number_of_matches=5)


def knn_flattened(pw):
    docs, q = docs_table(pw), queries_table(pw)
    index = pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, **kw(pw)).build_data_index(
        docs.vec, docs)
    return index.query_as_of_now(q.qvec, number_of_matches=4, collapse_rows=False)


def knn_l2sq_per_row_k(pw):
    docs, q = docs_table(pw), queries_table(pw, with_k=True)
    index = pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, metric="l2sq",
                                             **kw(pw)).build_data_index(docs.vec, docs)
    return index.query_as_of_now(q.qvec, number_of_matches=q.k)


def knn_metadata_filter(pw):
    docs, q = docs_table(pw), queries_table(pw)
    inner = pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, **kw(pw)).build_index(
        docs.vec, docs, metadata_column=docs.meta)
    di = pw.indexing.DataIndex(docs, inner)
    return (di.query_as_of_now(q.qvec, number_of_matches=3, metadata_filter="grp == `1`"),
            di.query_as_of_now(q.qvec, number_of_matches=3,
                               metadata_filter="globmatch('*.pdf', path) && grp != `2`"))


def bm25(pw):
    docs = docs_table(pw)
    q = pw.debug.table_from_rows(pw.schema_from_types(q=str), [(t,) for t in QTEXTS])
    index = pw.indexing.TantivyBM25Factory().build_data_index(docs.text, docs)
    return index.query_as_of_now(q.q, number_of_matches=4)


def hybrid_rrf(pw):
    docs, q = docs_table(pw), queries_table(pw)
    factory = pw.indexing.HybridIndexFactory(retriever_factories=[
        pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, **kw(pw)),
        pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=64, metric="l2sq", **kw(pw)),
    ])
    return factory.build_data_index(docs.vec, docs).query_as_of_now(q.qvec, number_of_matches=4)


def hnsw_default_usearch(pw):
    docs, q = docs_table(pw), queries_table(pw)
    index = pw.indexing.UsearchKnnFactory(dimensions=D, **kw(pw)).build_data_index(docs.vec, docs)
    return index.query_as_of_now(q.qvec, number_of_matches=5)


def ivf_usearch(pw):
    """``UsearchKnn`` with ``nlist``/``nprobe``: the IVF on the device (every
    cell probed, so the answers are exact over the bf16 cells)."""
    docs, q = docs_table(pw), queries_table(pw)
    inner = pw.indexing.UsearchKnn(docs.vec, dimensions=D, reserved_space=1024, nlist=4, nprobe=4, **kw(pw))
    return pw.indexing.DataIndex(docs, inner).query_as_of_now(q.qvec, number_of_matches=5)


def _stream_docs(pw):
    """Three epochs of documents keyed by name: the corpus, then upserts
    and deletes, then new documents and more deletes."""
    schema = pw.schema_builder({
        "name": pw.column_definition(dtype=str, primary_key=True),
        "vec": pw.column_definition(dtype=tuple),
    })
    rng = np.random.default_rng(11)
    cur = {f"d{i}": vec(VECS[i]) for i in range(24)}
    rows = [(n, v, 2, 1) for n, v in cur.items()]
    for n in ("d0", "d5", "d11"):  # moved: the queries near them change answers
        new = vec(rng.standard_normal(D))
        rows += [(n, cur[n], 4, -1), (n, new, 4, 1)]
        cur[n] = new
    for n in ("d3", "d7", "d23"):
        rows.append((n, cur.pop(n), 4, -1))
    for i in range(24, 28):
        cur[f"d{i}"] = vec(VECS[i])
        rows.append((f"d{i}", cur[f"d{i}"], 6, 1))
    for n in ("d1", "d2"):
        rows.append((n, cur.pop(n), 6, -1))
    return pw.debug.table_from_rows(schema, rows, is_stream=True)


def knn_query_consistent(pw):
    """``DataIndex.query`` (not as of now): the answers are revised as the
    corpus changes over three epochs."""
    docs, q = _stream_docs(pw), queries_table(pw)
    index = pw.indexing.BruteForceKnnFactory(dimensions=D, reserved_space=16, delta_cap=4, **kw(pw)).build_data_index(
        docs.vec, docs)
    return index.query(q.qvec, number_of_matches=3)


class _Params:
    value = None


def _tiny_params():
    if _Params.value is None:
        jcfg = graft._flagship_config(tiny=True)
        _Params.value = (jcfg, jax.tree.map(np.asarray, JittedEncoder(jcfg).params))
    return _Params.value


def knn_with_embedder(pw):
    """The embedder as the index's UDF on both sides: the port's
    ``TorchEncoderEmbedder`` on the CPU against ``TPUEncoderEmbedder``, the
    same flax parameters."""
    jcfg, params = _tiny_params()
    if pw is tpw:
        emb = TorchEncoderEmbedder(config=port_config(jcfg), params=params, max_batch_size=16, device="cpu")
    else:
        emb = TPUEncoderEmbedder(config=jcfg, params=params, max_batch_size=16)
    docs = docs_table(pw)
    q = pw.debug.table_from_rows(pw.schema_from_types(q=str), [(t,) for t in QTEXTS + TEXTS[:3]])
    index = pw.indexing.BruteForceKnnFactory(reserved_space=64, embedder=emb, **kw(pw)).build_data_index(
        docs.text, docs)
    return index.query_as_of_now(q.q, number_of_matches=3)


PIPELINES = [
    (knn_as_of_now, F32_TOL),
    (knn_flattened, F32_TOL),
    (knn_l2sq_per_row_k, F32_TOL),
    (knn_metadata_filter, F32_TOL),
    (bm25, 0.0),
    (hybrid_rrf, 0.0),
    (hnsw_default_usearch, F32_TOL),
    (ivf_usearch, BF16_TOL),
    (knn_query_consistent, F32_TOL),
    (knn_with_embedder, BF16_TOL),
]


def run(pw, build) -> list:
    """Each of ``build(pw)``'s tables through ``pw.debug``: (rows by id,
    update stream)."""
    pw.G.clear()
    tables = build(pw)
    tables = tables if isinstance(tables, tuple) else (tables,)
    out = pw.debug._run_capture(*tables)
    pw.G.clear()
    return [(t._column_names, rows, stream) for t, (rows, stream) in zip(tables, out)]


REPLY = ("_pw_index_reply_id", "_pw_index_reply_score", "_pw_index_reply")


def split_row(cols: list, values: tuple) -> tuple:
    """(the query's own values, {reply id: score}) of a result row; a
    flattened row has one reply (scalars), a collapsed one tuples."""
    row = dict(zip(cols, values))
    own = tuple(v for c, v in row.items() if c not in REPLY)
    ids, scores = row[REPLY[0]], row[REPLY[1]]
    if not isinstance(ids, tuple):
        ids, scores = (ids,), (scores,)
    return own, {int(i): float(s) for i, s in zip(ids, scores)}


def assert_replies_match(got: dict, want: dict, tol: float, what: str) -> None:
    assert got.keys() == want.keys(), what
    for key in want:
        assert got[key][0] == want[key][0], what
        g, w = got[key][1], want[key][1]
        assert g.keys() == w.keys(), f"{what}: reply ids differ for {want[key][0]}"
        for rid in w:
            assert abs(g[rid] - w[rid]) <= tol, (what, want[key][0], g[rid], w[rid])


def by_query(cols: list, rows: dict, flattened: bool) -> dict:
    """Rows by id; a flattened result's rows gathered by the query's own
    values, whose row ids come from the reply's rank."""
    out: dict = {}
    for rid, values in rows.items():
        own, replies = split_row(cols, tuple(values))
        if flattened:
            out.setdefault(own, (own, {}))[1].update(replies)
        else:
            out[int(rid)] = (own, replies)
    return out


@pytest.mark.parametrize("build,tol", PIPELINES, ids=[p.__name__ for p, _ in PIPELINES])
def test_data_index_pipeline_matches_jax_package(build, tol):
    want = run(jpw, build)
    before = dict(kernels.launch_counts())
    got = run(tpw, build)
    assert dict(kernels.launch_counts()) == before  # CPU tensors: the plain versions only
    assert len(got) == len(want)
    flattened = build is knn_flattened
    for (cols, grows, gstream), (wcols, wrows, wstream) in zip(got, want):
        assert cols == wcols
        assert wrows, f"{build.__name__}: the reference produced no rows"
        assert any(split_row(wcols, tuple(v))[1] for v in wrows.values()), "no reference replies"
        assert_replies_match(by_query(cols, grows, flattened), by_query(wcols, wrows, flattened), tol,
                             build.__name__)
        if build is knn_query_consistent:
            # the revisions themselves: the same (time, query, diff, reply ids)
            def revisions(stream):
                return sorted((t, int(k), d, tuple(sorted(split_row(cols, tuple(v))[1])))
                              for k, v, t, d in stream)

            assert revisions(gstream) == revisions(wstream)
            assert len({t for _, _, t, _ in gstream}) >= 3


def test_knn_query_consistent_revises_answers():
    """The consistent query of the stream above: answers are revised as
    the corpus changes, and no deleted document is in a final answer (the
    rows are held to the JAX package's above)."""
    ((cols, rows, stream),) = run(tpw, knn_query_consistent)
    data = cols.index(REPLY[2])
    final = {d["name"] for values in rows.values() for d in values[data]}
    assert final and not final & {"d3", "d7", "d23", "d1", "d2"}
    assert any(d < 0 for _, _, _, d in stream), "no answer was revised"


def test_usearch_factory_takes_ivf_arguments():
    """The port's ``UsearchKnnFactory`` passes ``nlist``/``nprobe`` to its
    inner index (the IVF adapter) and otherwise builds the HNSW."""
    from pathway_tpu_torch.stdlib.indexing.adapters import HnswAdapter, IvfAdapter

    tpw.G.clear()
    docs = docs_table(tpw)
    ivf = tpw.indexing.UsearchKnnFactory(dimensions=D, reserved_space=4096, nlist=16, nprobe=4,
                                         device="cpu").build_index(docs.vec, docs)
    adapter = ivf.make_adapter()
    assert isinstance(adapter, IvfAdapter)
    assert (adapter.index.main.nlist, adapter.index.main.nprobe) == (16, 4)
    assert adapter.index.main.dtype == torch.bfloat16 and adapter.index.main.device.type == "cpu"
    hnsw = tpw.indexing.UsearchKnnFactory(dimensions=D, device="cpu").build_index(docs.vec, docs)
    assert isinstance(hnsw.make_adapter(), HnswAdapter)
    knn = tpw.indexing.BruteForceKnnFactory(dimensions=D, device="cpu").build_index(docs.vec, docs)
    main = knn.make_adapter().index.main
    assert isinstance(main, ShardedKnnIndex) and main.dtype == torch.float32


# ---------------------------------------------------------------------------
# SegmentedIndex over both packages' indexes (tests/test_index_maintenance.py)

SD = 16  # vector width of the segment sequences
SK = 5

PKGS = {
    "jax": SimpleNamespace(
        Seg=JaxSegmented,
        make={
            "hnsw": lambda: JaxHnsw(SD, metric="cos"),
            "sharded": lambda: JaxSharded(SD, metric="cos", capacity=256),
            "ivf": lambda: JaxIvf(SD, metric="cos", capacity=1024, nlist=8, nprobe=8),
        },
        Sharded=lambda **k: JaxSharded(SD, metric="cos", **k),
        Hnsw=JaxHnsw,
    ),
    "port": SimpleNamespace(
        Seg=SegmentedIndex,
        make={
            "hnsw": lambda: HnswIndex(SD, metric="cos"),
            "sharded": lambda: ShardedKnnIndex(SD, metric="cos", capacity=256, device="cpu"),
            "ivf": lambda: IvfKnnIndex(SD, metric="cos", capacity=1024, nlist=8, nprobe=8, device="cpu"),
        },
        Sharded=lambda **k: ShardedKnnIndex(SD, metric="cos", device="cpu", **k),
        Hnsw=HnswIndex,
    ),
}
KINDS = ["hnsw", "sharded", "ivf"]


def _unit(rng, n=1):
    x = rng.standard_normal((n, SD)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _recall(seg, ref, queries, k=SK):
    got = seg.search(queries, k)
    keys = list(ref)
    mat = np.stack([ref[key] for key in keys])
    mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    scores = qn @ mat.T
    hits = total = 0
    for qi, reply in enumerate(got):
        kk = min(k, len(keys))
        truth = {keys[i] for i in np.argsort(-scores[qi])[:kk]}
        hits += len({key for key, _ in reply[:kk]} & truth)
        total += kk
    return hits / max(total, 1)


def _hits(seg, q, k) -> list:
    return [sorted(key for key, _ in reply) for reply in seg.search(q, k)]


def both(scenario, *args) -> None:
    """``scenario(ns, *args)`` over the JAX package's indexes and the port's;
    the observations (key sets, counters) must be equal."""
    obs = {name: scenario(ns, *args) for name, ns in PKGS.items()}
    assert obs["port"] == obs["jax"]


def _churn(ns, kind):
    rng = np.random.default_rng(42)
    ref: dict[str, np.ndarray] = {}
    seg = ns.Seg(ns.make[kind](), delta_cap=32, auto_merge=False)
    obs = []
    next_id = 0
    try:
        for step in range(12):
            items = []
            for _ in range(int(rng.integers(8, 24))):
                if ref and rng.random() < 0.3:
                    key = str(rng.choice(sorted(ref)))
                else:
                    key = f"k{next_id}"
                    next_id += 1
                v = _unit(rng)[0]
                items.append((key, v))
                ref[key] = v
            seg.add(items)
            if ref and step % 2:
                victims = [str(v) for v in rng.choice(sorted(ref), size=min(5, len(ref)), replace=False)]
                seg.remove(victims + [f"absent-{step}"])
                for v in victims:
                    del ref[v]
            if step in (4, 8, 10):
                seg.merge(wait=True)
            assert set(seg.keys()) == set(ref)
            probes = [str(v) for v in rng.choice(sorted(ref), size=4)]
            q = np.concatenate([np.stack([ref[p] for p in probes])
                                + 0.1 * rng.standard_normal((4, SD)).astype(np.float32), _unit(rng, 4)])
            assert _recall(seg, ref, q) >= 0.95
            obs.append((sorted(seg.keys()), _hits(seg, q, SK)))
        assert seg.merges_total == 3
        seg2 = ns.Seg(ns.make[kind](), delta_cap=32, auto_merge=False)
        seg2.load_state_dict(seg.state_dict())
        q = _unit(rng, 8)
        assert _recall(seg2, ref, q) >= 0.95
        obs.append((sorted(seg2.keys()), _hits(seg2, q, SK)))
        return obs
    finally:
        seg.close()


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_churn_recall_matches_jax(kind):
    both(_churn, kind)


def _upsert_visible(ns, kind):
    rng = np.random.default_rng(0)
    seg = ns.Seg(ns.make[kind](), delta_cap=64, auto_merge=False)
    x = _unit(rng, 8)
    seg.add([(f"k{i}", x[i]) for i in range(8)])
    assert len(seg.main) == 0
    (res,) = seg.search(x[:1], 1)
    assert res[0][0] == "k0"
    seg.remove(["k3"])
    (res,) = seg.search(x[3:4], 8)
    assert "k3" not in {k for k, _ in res}
    return sorted(k for k, _ in res)


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_upsert_visible_before_merge_matches_jax(kind):
    both(_upsert_visible, kind)


def _bulk_load(ns, kind):
    rng = np.random.default_rng(1)
    seg = ns.Seg(ns.make[kind](), delta_cap=16, auto_merge=False)
    x = _unit(rng, 32)
    seg.add([(f"k{i}", x[i]) for i in range(32)])
    assert len(seg.main) == 32 and not seg._delta and len(seg) == 32
    return _hits(seg, x[:4], 3)


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_bulk_load_goes_straight_to_main_matches_jax(kind):
    both(_bulk_load, kind)


def _auto_merge(ns, kind):
    rng = np.random.default_rng(2)
    seg = ns.Seg(ns.make[kind](), delta_cap=8, tombstone_fraction=0.25, auto_merge=True)
    try:
        x = _unit(rng, 64)
        for i in range(8):
            seg.add([(f"k{i}", x[i])])
        seg._maintenance.drain()
        assert seg.merges_total == 1 and not seg._delta and len(seg.main) == 8
        seg.add([(f"k{i}", x[i]) for i in range(8, 64)])
        seg.remove([f"k{i}" for i in range(20)])
        seg._maintenance.drain()
        assert seg.merges_total == 2, seg.stats()
        assert len(seg.main) == 44 and not seg._tombs and len(seg) == 44
        return sorted(seg.keys()), _hits(seg, x[20:24], 4)
    finally:
        seg.close()


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_auto_merge_matches_jax(kind):
    both(_auto_merge, kind)


def _failed_merge(ns, kind):
    rng = np.random.default_rng(4)
    seg = ns.Seg(ns.make[kind](), delta_cap=8, auto_merge=False)
    x = _unit(rng, 40)
    seg.add([(f"m{i}", x[i]) for i in range(32)])
    seg.add([(f"d{i}", x[32 + i]) for i in range(5)])
    seg.remove(["m2"])
    before_keys = set(seg.keys())
    before_hits = seg.search(x[:4], 3)

    def boom(*_a, **_k):
        raise RuntimeError("merge died")

    # a rebuild dies making the fresh main, an in-place merge adding to it
    hook = "fresh" if kind == "hnsw" else "add"
    setattr(seg.main, hook, boom)
    with pytest.raises(RuntimeError, match="merge died"):
        seg.merge(wait=True)
    assert seg.merge_failures == 1 and not seg._merging
    assert set(seg.keys()) == before_keys
    assert len(seg._delta) == 5 and seg._tombs <= {"m2"}
    assert _hits(seg, x[:4], 3) == [sorted(k for k, _ in r) for r in before_hits]
    delattr(seg.main, hook)
    seg.merge(wait=True)
    assert not seg._delta and not seg._tombs and set(seg.keys()) == before_keys
    return sorted(before_keys), _hits(seg, x[:4], 3)


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_failed_merge_rolls_back_matches_jax(kind):
    both(_failed_merge, kind)


def _upsert_during_merge(ns, kind):
    rng = np.random.default_rng(5)
    seg = ns.Seg(ns.make[kind](), delta_cap=8, auto_merge=False)
    seg.add([(f"m{i}", v) for i, v in enumerate(_unit(rng, 16))])  # bulk -> main
    old = _unit(rng)[0]
    new = -old
    seg.add([("k", old)])
    seg._pre_commit = lambda: seg.add([("k", new)])
    seg.merge(wait=True)
    del seg._pre_commit
    (res,) = seg.search(new[None, :], 1)
    assert res[0][0] == "k" and res[0][1] > 0.99
    seg.merge(wait=True)
    assert not seg._delta
    (res,) = seg.search(new[None, :], 1)
    assert res[0][0] == "k" and res[0][1] > 0.99
    return len(seg), res[0][0]


def _remove_during_merge(ns, kind):
    rng = np.random.default_rng(11)
    seg = ns.Seg(ns.make[kind](), delta_cap=8, auto_merge=False)
    x = _unit(rng, 48)
    seg.add([(f"m{i}", x[i]) for i in range(32)])
    seg.add([("victim", x[40]), ("d0", x[41]), ("d1", x[42])])
    seen = {}

    def in_window():
        seg.remove(["victim"])
        (hits,) = seg.search(x[40][None, :], 8)
        seen["mid"] = sorted(key for key, _ in hits)
        seen["state"] = seg.state_dict()

    seg._pre_commit = in_window
    seg.merge(wait=True)
    del seg._pre_commit
    assert "victim" not in seen["mid"] and "victim" not in set(seen["state"]["delta_keys"])
    seg.merge(wait=True)
    assert "victim" not in seg
    restored = ns.Seg(ns.make[kind](), delta_cap=8, auto_merge=False)
    restored.load_state_dict(seen["state"])
    restored.merge(wait=True)
    assert "victim" not in restored and set(restored.keys()) == set(seg.keys())
    return seen["mid"], _hits(seg, x[40][None, :], 8), _hits(restored, x[40][None, :], 8)


@pytest.mark.parametrize("scenario", [_upsert_during_merge, _remove_during_merge], ids=["upsert", "remove"])
@pytest.mark.parametrize("kind", KINDS)
def test_segmented_update_during_merge_matches_jax(kind, scenario):
    both(scenario, kind)


def _state_dict_racing_merge(ns, kind):
    rng = np.random.default_rng(3)
    seg = ns.Seg(ns.make[kind](), delta_cap=8, auto_merge=False)
    x = _unit(rng, 48)
    seg.add([(f"m{i}", x[i]) for i in range(32)])
    seg.add([(f"d{i}", x[32 + i]) for i in range(6)])
    seg.remove(["m0", "m1"])
    pre = seg.state_dict()
    pre_keys = set(seg.keys())
    captured = {}
    seg._pre_commit = lambda: captured.update(mid=seg.state_dict())
    seg.merge(wait=True)
    mid = captured["mid"]
    assert set(mid["delta_keys"]) == set(pre["delta_keys"])
    assert set(mid["tombstones"]) == set(pre["tombstones"])
    restored = ns.Seg(ns.make[kind](), delta_cap=8, auto_merge=False)
    restored.load_state_dict(mid)
    assert set(restored.keys()) == pre_keys
    post = seg.state_dict()
    assert not post["delta_keys"] and not post["tombstones"]
    assert len(seg.main) == len(pre_keys) and set(seg.keys()) == pre_keys
    return sorted(mid["delta_keys"]), sorted(mid["tombstones"]), _hits(restored, x[:4], 3)


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_state_dict_racing_merge_matches_jax(kind):
    both(_state_dict_racing_merge, kind)


def _concurrent(ns, kind):
    seg = ns.Seg(ns.make[kind](), delta_cap=16, auto_merge=True)
    rng = np.random.default_rng(15)
    ref: dict[str, np.ndarray] = {}
    errors: list[BaseException] = []
    stop = threading.Event()

    def searcher(seed):
        srng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                seg.search(_unit(srng, 2), 3)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=searcher, args=(100 + i,)) for i in range(2)]
    for t in threads:
        t.start()
    try:
        next_id = 0
        for step in range(30):
            items = []
            for _ in range(6):
                key = f"k{next_id}"
                next_id += 1
                v = _unit(rng)[0]
                items.append((key, v))
                ref[key] = v
            seg.add(items)
            if step % 3 == 2:
                victims = [str(v) for v in rng.choice(sorted(ref), size=4, replace=False)]
                seg.remove(victims + ["absent"])
                for v in victims:
                    del ref[v]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        seg.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert set(seg.keys()) == set(ref)
    assert _recall(seg, ref, _unit(rng, 8)) >= 0.95
    return sorted(seg.keys())


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_concurrent_queries_and_updates_matches_jax(kind):
    both(_concurrent, kind)


def _stale_handle(ns):
    """A segment probe dispatched before ``load_state_dict`` is recovered by
    re-running the search (the sharded index's stale handle raises
    ``RuntimeError``, which ``SegmentedIndex.collect`` catches)."""
    rng = np.random.default_rng(16)
    seg = ns.Seg(ns.Sharded(capacity=128), delta_cap=4, auto_merge=False)
    x = _unit(rng, 8)
    seg.add([(f"a{i}", x[i]) for i in range(8)])  # bulk -> main
    state = seg.state_dict()
    handle = seg.dispatch(x[:2], 2)
    seg.load_state_dict(state)
    with pytest.raises(RuntimeError, match="stale dispatch handle"):
        seg.main.collect(handle.probe)
    rows = seg.collect(handle)
    assert seg.stats()["probes_recovered"] == 1
    assert [r[0][0] for r in rows] == ["a0", "a1"]
    return [[k for k, _ in r] for r in rows], seg.stats()["probes_dispatched"]


def test_segmented_stale_handle_after_load_state_dict_matches_jax():
    both(_stale_handle)


# ---------------------------------------------------------------------------
# compile_filter (tests/test_indexing_filters.py)

M = {
    "path": "/docs/report-2024.pdf",
    "owner": {"name": "ada", "age": 37},
    "tags": "alpha beta",
    "modified_at": 1700000000,
    "score": 2.5,
}
FILTERS = [
    "modified_at == `1700000000`", "modified_at != `1700000000`", "modified_at > `1699999999`",
    "modified_at >= `1700000000`", "modified_at < `1700000000`", "score == `2.5`", "owner.name == 'ada'",
    "owner.name == 'bob'", "owner.age <= `37`", "contains(tags, 'beta')", "contains(tags, 'gamma')",
    "globmatch('*.pdf', path)", "globmatch('*.docx', path)", "globmatch('/docs/*', path)",
    "owner.name == 'ada' && score > `2`", "owner.name == 'ada' && score > `3`",
    "owner.name == 'bob' || contains(tags, 'alpha')", "!(owner.name == 'bob')",
    "!(owner.name == 'ada') || modified_at > `0`", "(score > `2` || score < `1`) && owner.age == `37`",
    "nosuch.field == 'x'", "owner > `3`", 'owner.name == "ada"', "path == '/docs/report-2024.pdf'",
]


@pytest.mark.parametrize("expr", FILTERS)
def test_compile_filter_matches_jax(expr):
    metas = [M, {}, None, {"owner": {"name": "bob", "age": 3}, "score": 0.5, "tags": ["beta"]}]
    got = [tfilters.compile_filter(expr)(m) for m in metas]
    assert got == [jfilters.compile_filter(expr)(m) for m in metas]
    assert all(isinstance(g, bool) for g in got)
    assert tfilters.compile_filter(expr) is tfilters.compile_filter(expr)  # memoized


def test_consolidate_tells_wide_vectors_in_dict_cells_apart():
    """A reply's data snapshot holds the indexed row's vector.  Rows whose
    dict cells hold arrays that differ only past the first and last three
    of over 1,000 elements stay two rows (a JSON of ``str(array)`` would
    summarise them equal and cancel the pair), equal ones cancel."""
    from pathway_tpu_torch.engine.stream import Update, consolidate, hashable

    a = np.zeros(1024, np.float32)
    b = a.copy()
    b[500] = 1.0
    assert str(a) == str(b)
    kept = consolidate([Update(1, ("q", {"v": a}), -1), Update(1, ("q", {"v": b}), 1)])
    assert sorted(u.diff for u in kept) == [-1, 1]
    assert consolidate([Update(1, ("q", {"v": a}), -1), Update(1, ("q", {"v": a.copy()}), 1)]) == []
    # a cell that has no hashable form keeps the JSON form
    assert hashable({"s": {1, 2}})[0] == "__dict__"
