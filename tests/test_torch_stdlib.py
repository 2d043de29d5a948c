"""The port's streaming stdlib beyond temporal (``pw.iterate``,
``pw.graphs``, ``pw.ordered``, ``pw.stateful``, ``pw.statistical``,
``pw.universes`` and ``pw.ml``) against the JAX package's, on the CPU.

Every case of ``tests/test_stdlib_algorithms.py``, ``test_graphs.py``,
``test_stateful_utils.py`` and ``test_async_iterate.py``, and the iterate,
graph, kNN, HMM, fuzzy-match and universe cases of
``tests/test_stdlib_misc.py``, is written once, as a function of the
package module, and runs through both packages with the same inputs: the
final rows are equal by id (floats on host arithmetic within 1e-9, where
a kernel's plain version is on the path within ``F32_TOL``), and the JAX
test's own assertions hold on the port's output.  ``KNNIndex`` runs in
both metrics and both query forms, with and without distances, on seeded
16-d vectors and on the flagship tiny encoder as the embedding UDF (the
port's kNN indexes on ``device="cpu"``, the plain version of K3).  Phase
19's graph (``chip_smoke.stdlib_graph``) runs at a tiny width in both
packages, at ``optimize`` 0 and 2 in the port: predictions, window and
join counts, edges, ranks and distances are equal, and the port's pass
``chip_smoke.stdlib_check`` against numpy and scipy.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from importlib import import_module

import numpy as np
import pytest
import torch

import chip_smoke
import pathway_tpu as jpw
import pathway_tpu_torch as tpw

F32_TOL = 1e-5
HOST_TOL = 1e-9
BOTH = (jpw, tpw)


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


def knn(pw) -> dict:
    """The device argument of the port's kNN indexes (the JAX package's
    take none)."""
    return {"device": "cpu"} if pw is tpw else {}


def norm(v):
    """A value in a form both packages' values compare in."""
    if type(v).__name__ == "_Error":
        return ("Error",)
    if type(v).__name__ == "Pointer":
        return ("Pointer", int(v))
    if type(v).__name__ == "Json":
        return ("Json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, np.ndarray):
        return tuple(norm(x) for x in v.tolist())
    if isinstance(v, (tuple, list)):
        return tuple(norm(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def close(a, b, tol: float) -> bool:
    """Equal values, floats (also inside tuples) within ``tol`` relative."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= tol * max(1.0, abs(a), abs(b))
    return a == b


def capture(pw, build) -> list:
    """``build(pw)``'s tables run through ``pw.debug``: per table, its final
    rows by id, normalised."""
    pw.G.clear()
    tables = build(pw)
    tables = tables if isinstance(tables, tuple) else (tables,)
    out = [{norm(k): norm(tuple(v)) for k, v in rows.items()} for rows, _ in pw.debug._run_capture(*tables)]
    pw.G.clear()
    return out


def run_both(build, tol: float = HOST_TOL) -> list:
    """``build`` through both packages: the same ids, rows equal within
    ``tol``; the port's rows per table."""
    want = capture(jpw, build)
    got = capture(tpw, build)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert close(g[k], w[k], tol), (k, g[k], w[k])
    return got


def values(rows: dict) -> list:
    """The final rows as ``tests.utils.run_to_rows`` orders them."""
    return sorted(rows.values(), key=repr)


def both_equal(fn):
    """``fn(pw)`` in each package (each on a fresh graph): equal results;
    the port's."""
    out = {}
    for pw in BOTH:
        pw.G.clear()
        try:
            out[pw] = fn(pw)
        finally:
            pw.G.clear()
    assert out[tpw] == out[jpw]
    return out[tpw]


# ---------------------------------------------------------------------------
# graphs (tests/test_stdlib_algorithms.py, test_stdlib_misc.py, test_graphs.py)


def _graph(pw, v_md, e_md, cast_dist: bool = True):
    v = pw.debug.table_from_markdown(v_md).select(
        name=pw.this.name, dist=pw.apply(lambda d: 0.0 if str(d) == "0" else None, pw.this.dist0))
    vertices = v.with_id_from(pw.this.name)
    e = pw.debug.table_from_markdown(e_md)
    edges = e.select(u=vertices.pointer_from(e.u), v=vertices.pointer_from(e.v),
                     dist=pw.cast(float, e.dist) if cast_dist else e.dist)
    return vertices, edges


def test_bellman_ford_shortest_paths_chain_vs_shortcut():
    def build(pw):
        vertices, edges = _graph(pw, "name | dist0\na | 0\nb | __none__\nc | __none__\nd | __none__",
                                 "u | v | dist\na | b | 1\nb | c | 1\nc | d | 1\na | d | 10")
        return pw.graphs.bellman_ford(vertices, edges)

    ((rows),) = run_both(build)
    assert sorted(r[0] for r in values(rows)) == [0.0, 1.0, 2.0, 3.0]


def test_bellman_ford():
    def build(pw):
        vertices, edges = _graph(pw, "name | dist0\na | 0\nb | __none__\nc | __none__",
                                 "u | v | dist\na | b | 1\nb | c | 1\na | c | 5", cast_dist=False)
        return pw.graphs.bellman_ford(vertices, edges)

    ((rows),) = run_both(build)
    assert sorted(r[0] for r in values(rows)) == [0.0, 1.0, 2.0]


def _pagerank(md: str, steps: int):
    def build(pw):
        e = pw.debug.table_from_markdown(md)
        return pw.graphs.pagerank(e.select(u=pw.this.un, v=pw.this.vn), steps=steps)

    ((rows),) = run_both(build)
    return {r[0]: r[1] for r in values(rows)}


def test_pagerank_star_center_dominates():
    by_node = _pagerank("un | vn\na | z\nb | z\nc | z\nz | a\nz | b\nz | c", 14)
    assert by_node["z"] > 2 * max(v for k, v in by_node.items() if k != "z")


def test_pagerank_symmetric_cycle_uniform():
    vals = list(_pagerank("un | vn\na | b\nb | c\nc | a", 12).values())
    assert max(vals) - min(vals) < 1e-6


def test_pagerank():
    vals = list(_pagerank("un | vn\na | b\nb | c\nc | a", 10).values())
    assert len(vals) == 3 and all(abs(v - 1.0) < 0.1 for v in vals)


def test_louvain_two_cliques():
    def build(pw):
        e = pw.debug.table_from_markdown(
            "u | v | weight\na | b | 1\nb | c | 1\na | c | 1\nx | y | 1\ny | z | 1\nx | z | 1\na | x | 0.1")
        return pw.graphs.louvain_level(pw.graphs.WeightedGraph(e))

    ((rows),) = run_both(build)
    by_node = {r[0]: r[1] for r in values(rows)}
    assert by_node["a"] == by_node["b"] == by_node["c"]
    assert by_node["x"] == by_node["y"] == by_node["z"]
    assert by_node["a"] != by_node["x"]


def test_gradual_broadcast_appends_apx_value():
    def build(pw):
        t = pw.debug.table_from_markdown("a\n1\n2\n3")
        th = t.reduce(m=pw.reducers.sum(pw.this.a)).select(
            lower=pw.apply(lambda m: m - 1.0, pw.this.m), value=pw.apply(float, pw.this.m),
            upper=pw.apply(lambda m: m + 1.0, pw.this.m))
        return t._gradual_broadcast(th, th.lower, th.value, th.upper)

    ((rows),) = run_both(build)
    assert {r[-1] for r in rows.values()} == {6.0}
    assert sorted(r[0] for r in rows.values()) == [1, 2, 3]


def test_gradual_broadcast_damps_churn():
    """The update streams too: a move within the window re-emits nothing."""

    def stream(pw):
        t = pw.debug.table_from_markdown("a | __time__ | __diff__\n1 | 2 | 1\n2 | 2 | 1")
        th = pw.debug.table_from_markdown(
            """
        lower | value | upper | __time__ | __diff__
        5.0   | 6.0   | 8.0   | 2        | 1
        5.0   | 7.0   | 8.0   | 4        | 1
        20.0  | 21.0  | 22.0  | 6        | 1
        """
        )
        b = t._gradual_broadcast(th, th.lower, th.value, th.upper)
        ((_, updates),) = pw.debug._run_capture(b)
        return sorted(((norm(k), norm(tuple(v)), time, diff) for k, v, time, diff in updates), key=repr)

    updates = both_equal(stream)
    apx = [(vals[-1], time, diff) for _k, vals, time, diff in updates]
    assert (6.0, 2, 1) in apx and not any(time == 4 for _v, time, _d in apx)
    assert (6.0, 6, -1) in apx and (21.0, 6, 1) in apx


def _two_cliques(pw):
    rows = [(u, v, 1.0) for members in (range(5), range(5, 10)) for u, v in itertools.combinations(members, 2)]
    rows.append((0, 5, 0.1))  # weak bridge
    return pw.debug.table_from_rows(pw.schema_from_types(u=int, v=int, weight=float), rows)


def test_louvain_communities_two_cliques():
    def run(pw):
        g = pw.graphs.WeightedGraph(_two_cliques(pw))
        lc = pw.graphs.louvain_communities(g, levels=2)
        keys, cols = pw.debug.table_to_dicts(lc.final_clustering)
        assign = {cols["v"][k]: cols["c"][k] for k in keys}
        _, hcols = pw.debug.table_to_dicts(lc.hierarchical_clustering)
        _, mcols = pw.debug.table_to_dicts(pw.graphs.exact_modularity(g, lc.final_clustering))
        (q,) = mcols["modularity"].values()
        return ({v: norm(c) for v, c in assign.items()}, sorted(set(hcols["level"].values())), q)

    want = None
    for pw in BOTH:
        pw.G.clear()
        got = run(pw)
        pw.G.clear()
        if want is None:
            want = got
    assert got[0] == want[0] and got[1] == want[1] and close(got[2], want[2], HOST_TOL)
    assign, levels, q = got
    assert len(assign) == 10
    c_a, c_b = {assign[i] for i in range(5)}, {assign[i] for i in range(5, 10)}
    assert len(c_a) == 1 and len(c_b) == 1 and c_a != c_b
    assert levels == [0, 1, 2] and q > 0.45


def test_louvain_level_with_gradual_total_weight():
    def build(pw):
        edges = _two_cliques(pw)
        tw = import_module(f"{pw.__name__}.stdlib.graphs")._approximate_total_weight(edges)
        return pw.graphs.louvain_level(pw.graphs.WeightedGraph(edges), total_weight=tw)

    ((rows),) = run_both(build)
    assign = {r[0]: r[1] for r in rows.values()}
    assert len({assign[i] for i in range(5)}) == 1 and len({assign[i] for i in range(5, 10)}) == 1


# ---------------------------------------------------------------------------
# ordered, statistical (tests/test_stdlib_algorithms.py)


def test_sort_produces_prev_next_chain():
    def build(pw):
        t = pw.debug.table_from_markdown("v\n30\n10\n20")
        s = pw.ordered.sort(t, key=t.v)
        return t.with_columns(prev=s.prev, next=s.next)

    ((rows),) = run_both(build)
    assert [v[1] for v in rows.values()].count(None) == 1 and [v[2] for v in rows.values()].count(None) == 1
    head = next(k for k, v in rows.items() if v[1] is None)
    walk, k = [], head
    while k is not None:
        walk.append(rows[k][0])
        k = rows[k][2]
    assert walk == [10, 20, 30]


def test_diff_computes_ordered_deltas():
    def build(pw):
        t = pw.debug.table_from_markdown("ts | v\n1  | 10\n2  | 15\n4  | 25")
        return t.diff(t.ts, t.v).select(pw.this.diff_v)

    ((rows),) = run_both(build)
    got = values(rows)
    assert sorted(r[0] for r in got if r[0] is not None) == [5, 10]
    assert sum(1 for r in got if r[0] is None) == 1


def test_interpolate_linear_fills_gaps():
    def build(pw):
        t = pw.debug.table_from_markdown("ts | v\n0  | 0.0\n10 | 100.0\n5  |")
        out = pw.statistical.interpolate(t, t.ts, t.v)
        return out.select(pw.this.ts, pw.this.v)

    ((rows),) = run_both(build)
    vals = dict(values(rows))
    assert vals[0] == 0.0 and vals[10] == 100.0 and vals[5] == pytest.approx(50.0)


# ---------------------------------------------------------------------------
# LSH, fuzzy match, HMM (tests/test_stdlib_algorithms.py, test_stdlib_misc.py)


def test_lsh_knn_index_finds_close_neighbors():
    got = {}
    for pw in BOTH:
        rng = np.random.default_rng(0)
        idx = pw.ml.classifiers.LshBandingIndex(16, metric="euclidean", A=4.0)
        base = rng.normal(size=(30, 16))
        for i, v in enumerate(base):
            idx.add(i, v)
        got[pw] = idx.query(base[7] + rng.normal(scale=1e-3, size=16), k=3)
    assert got[tpw] == got[jpw]
    assert got[tpw] and got[tpw][0][0] == 7


def test_lsh_bucketers_are_deterministic_and_locality_sensitive():
    for gen in ("euclidean", "cosine"):
        out = {}
        for pw in BOTH:
            c = pw.ml.classifiers
            b = c.generate_euclidean_lsh_bucketer(8, 3, 4, 2.0) if gen == "euclidean" else \
                c.generate_cosine_lsh_bucketer(8, 3, 4)
            rng = np.random.default_rng(1)
            x = rng.normal(size=8)
            near, far = x + rng.normal(scale=1e-4, size=8), rng.normal(size=8) * 10
            assert b(x) == b(x)
            same_near = sum(1 for p, q in zip(b(x), b(near)) if p == q)
            same_far = sum(1 for p, q in zip(b(x), b(far)) if p == q)
            assert same_near >= same_far
            out[pw] = norm(b(x))
        assert out[tpw] == out[jpw]


def test_fuzzy_self_match_pairs_identical_texts():
    def build(pw):
        a = pw.debug.table_from_markdown("txt\nalpha_beta_gamma\ndelta_epsilon")
        b = pw.debug.table_from_markdown("txt\nalpha_beta_gamma\nzeta_eta")
        return pw.ml.smart_table_ops.fuzzy_match_tables(a, b)

    ((rows),) = run_both(build)
    assert rows


def test_fuzzy_match():
    def build(pw):
        left = pw.debug.table_from_markdown("ln | name\n1  | john smith\n2  | acme corp ltd")
        right = pw.debug.table_from_markdown("rn | title\na  | smith john\nb  | acme corporation")
        return pw.ml.smart_table_ops.fuzzy_match_tables(left, right, left_column=left.name,
                                                        right_column=right.title)

    ((rows),) = run_both(build)
    got = values(rows)
    assert len(got) == 2 and sorted(r[2] for r in got)[0] > 0.2


def test_hmm_reducer():
    def build(pw):
        hmm = pw.ml.hmm.create_hmm_reducer(
            graph={"sunny": {"sunny": 0.9, "rainy": 0.1}, "rainy": {"rainy": 0.9, "sunny": 0.1}})
        t = pw.debug.table_from_markdown("k | t | obs\na | 1 | sunny\na | 2 | sunny\na | 3 | rainy\na | 4 | rainy")
        return t.groupby(t.k).reduce(state=hmm(pw.make_tuple(t.t, t.obs)))

    ((rows),) = run_both(build)
    assert values(rows) == [("rainy",)]


# ---------------------------------------------------------------------------
# KNNIndex and the classifier (tests/test_stdlib_misc.py) and both metrics,
# both query forms, with and without distances


def _vec_table(pw, md: str, x: str, y: str, name: str = "vec", label: bool = True):
    """A markdown table's ``x``, ``y`` as a 2-d vector column ``name``
    (beside its ``label`` where ``label``)."""
    t = pw.debug.table_from_markdown(md)
    vec = pw.apply(lambda a, b: (float(a), float(b)), t[x], t[y])
    return t.select(label=t.label, **{name: vec}) if label else t.select(**{name: vec})


def test_knn_index_legacy():
    def build(pw):
        data = _vec_table(pw, "label | x  | y\nl1    | 1  | 0\nl2    | 0  | 1", "x", "y")
        index = pw.ml.KNNIndex(data.vec, data, n_dimensions=2, **knn(pw))
        queries = _vec_table(pw, "qx | qy\n1  | 0", "qx", "qy", label=False)
        return index.get_nearest_items(queries.vec, k=1)

    ((rows),) = run_both(build, F32_TOL)
    assert [r for r in values(rows)[0] if isinstance(r, tuple) and r and isinstance(r[0], str)][0] == ("l1",)


def test_knn_classifier():
    def build(pw):
        data = _vec_table(pw, "label | x | y\nA | 1 | 0\nA | 1 | 1\nB | 0 | 1", "x", "y", name="data")
        index = pw.ml.classifiers.knn_lsh_train(data, d=2, **knn(pw))
        queries = _vec_table(pw, "x | y\n1 | 0", "x", "y", name="data", label=False)
        return pw.ml.classifiers.knn_lsh_classify(index, queries.data, k=3)

    ((rows),) = run_both(build, F32_TOL)
    assert values(rows) == [("A",)]


def test_knn_index_takes_device_and_raises_without_a_card():
    """The port's ``KNNIndex`` and ``knn_lsh_train`` place their slab on
    ``device`` (default ``"cuda"``): with no card, building the index
    raises, asking for ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    data = _vec_table(tpw, "label | x | y\nA | 1 | 0", "x", "y", name="data")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpw.ml.KNNIndex(data.data, data, n_dimensions=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpw.ml.classifiers.knn_lsh_train(data, d=2)


@pytest.mark.parametrize("with_distances", [False, True])
@pytest.mark.parametrize("form", ["consistent", "asof_now"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_index_forms_match_jax(metric, form, with_distances):
    """Seeded 16-d vectors: the same ids, distances within ``F32_TOL``."""
    rng = np.random.default_rng(24)
    data_rows = [(f"d{i}", i % 3, tuple(map(float, v))) for i, v in enumerate(rng.standard_normal((40, 16)))]
    query_rows = [(f"q{i}", tuple(map(float, v))) for i, v in enumerate(rng.standard_normal((6, 16)))]

    def build(pw):
        data = pw.debug.table_from_rows(pw.schema_from_types(name=str, label=int, vec=tuple), data_rows)
        queries = pw.debug.table_from_rows(pw.schema_from_types(qname=str, qvec=tuple), query_rows)
        index = pw.ml.KNNIndex(data.vec, data, n_dimensions=16, distance_type=metric, **knn(pw))
        fn = index.get_nearest_items if form == "consistent" else index.get_nearest_items_asof_now
        return fn(queries.qvec, k=4, with_distances=with_distances)

    ((rows),) = run_both(build, F32_TOL)
    assert len(rows) == 6 and all(len(r[2]) == 4 for r in rows.values())


@pytest.fixture(scope="module")
def tiny_encoder():
    import jax

    import __graft_entry__ as graft
    from pathway_tpu.parallel import JittedEncoder
    from test_torch_encoder import port_config

    jcfg = graft._flagship_config(tiny=True)
    return jcfg, port_config(jcfg), jax.tree.map(np.asarray, JittedEncoder(jcfg).params)


def embedder(pw, tiny, batch: int = 16):
    """The flagship tiny encoder as each package's embedding UDF (the port
    maps the flax parameters through ``state_dict_from_flax``)."""
    jcfg, tcfg, params = tiny
    if pw is jpw:
        from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder

        return chip_smoke.recording_embedder(TPUEncoderEmbedder)(config=jcfg, params=params, max_batch_size=batch)
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder

    return chip_smoke.recording_embedder(TorchEncoderEmbedder)(config=tcfg, params=params, max_batch_size=batch,
                                                              device="cpu")


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_index_over_tiny_encoder_udf(tiny_encoder, metric):
    """Texts embedded by the tiny encoder as a UDF, indexed and queried
    with distances, and classified: ids equal, distances within
    ``F32_TOL``, predicted labels equal."""
    rng = np.random.default_rng(25)
    docs = [(f"t{j % 4} " * 6 + " ".join(f"w{w}" for w in rng.integers(0, 300, 12)), j % 4) for j in range(24)]
    questions = [(f"t{j % 4} " * 6 + " ".join(f"w{w}" for w in rng.integers(0, 300, 12)),) for j in range(5)]

    def build(pw):
        emb = embedder(pw, tiny_encoder)
        data = pw.debug.table_from_rows(pw.schema_from_types(text=str, label=int), docs)
        data = data.select(label=pw.this.label, data=emb(pw.this.text))
        qs = pw.debug.table_from_rows(pw.schema_from_types(text=str), questions)
        qs = qs.select(qvec=emb(pw.this.text))
        index = pw.ml.classifiers.knn_lsh_train(data, d=tiny_encoder[0].hidden, type=metric, **knn(pw))
        near = index.get_nearest_items(qs.qvec, k=3, with_distances=True).select(pw.this.label, pw.this.dist)
        return near, pw.ml.classifiers.knn_lsh_classify(index, qs.qvec, k=3)

    near, predicted = run_both(build, F32_TOL)
    assert len(near) == len(predicted) == 5


# ---------------------------------------------------------------------------
# stateful and utils (tests/test_stateful_utils.py)


def _dedup_history(pw) -> list:
    t = pw.debug.table_from_markdown(
        """
    v  | __time__ | __diff__
    3  | 2        | 1
    1  | 4        | 1
    7  | 6        | 1
    5  | 8        | 1
    """
    )
    d = t.deduplicate(value=pw.this.v, acceptor=lambda new, old: old is None or new > old)
    history: list = []
    pw.io.subscribe(d, on_change=lambda k, row, tm, add: history.append((add, row["v"])))
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    return history


def test_deduplicate_acceptor_keeps_increasing_values():
    history = both_equal(_dedup_history)
    assert [v for add, v in history if add] == [3, 7]


def test_deduplicate_per_instance_streams_independently():
    def build(pw):
        t = pw.debug.table_from_markdown(
            "g | v | __time__ | __diff__\na | 1 | 2 | 1\nb | 9 | 2 | 1\na | 5 | 4 | 1\nb | 2 | 4 | 1")
        d = t.deduplicate(value=pw.this.v, instance=pw.this.g, acceptor=lambda new, old: old is None or new > old)
        return d.select(pw.this.g, pw.this.v)

    ((rows),) = run_both(build)
    assert sorted(values(rows)) == [("a", 5), ("b", 9)]


def test_deduplicate_acceptor_exception_contained():
    def run(pw):
        t = pw.debug.table_from_markdown("v\n1\n2")

        def explosive(new, old):
            if new == 2:
                raise RuntimeError("acceptor exploded")
            return old is None

        d = t.deduplicate(value=pw.this.v, acceptor=explosive)
        err = pw.global_error_log()
        cap_d, cap_e = d._capture_node(), err._capture_node()
        ctx = pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return (any("acceptor" in v[0] for v in ctx.state(cap_e)["rows"].values()),
                [v[0] for v in ctx.state(cap_d)["rows"].values()])

    logged, held = both_equal(run)
    assert logged and held == [1]


def test_deduplicate_is_append_only():
    def build(pw):
        t = pw.debug.table_from_markdown("v | __time__ | __diff__\n5 | 2 | 1\n5 | 4 | -1\n1 | 6 | 1")
        d = t.deduplicate(value=pw.this.v, acceptor=lambda new, old: old is None or new > old)
        return d.select(pw.this.v)

    ((rows),) = run_both(build)
    assert [v[0] for v in values(rows)] == [5]


def test_unpack_col_expands_tuples():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(packed=tuple), [((1, "x"),), ((2, "y"),)])
        out = pw.utils.col.unpack_col(t.packed, "num", "label")
        assert out.column_names() == ["num", "label"]
        return out

    ((rows),) = run_both(build)
    assert sorted(values(rows)) == [(1, "x"), (2, "y")]


def test_apply_all_rows_sees_whole_column():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(v=int), [(1,), (2,), (3,)])
        return pw.utils.col.apply_all_rows(t.v, fun=lambda vs: [v / sum(vs) for v in vs], result_col_name="share")

    ((rows),) = run_both(build)
    assert sorted(r[-1] for r in values(rows)) == pytest.approx([1 / 6, 2 / 6, 3 / 6])


# ---------------------------------------------------------------------------
# AsyncTransformer and iterate (tests/test_async_iterate.py, test_stdlib_misc.py)


def _doubler(pw):
    class Doubler(pw.AsyncTransformer):
        output_schema = pw.schema_from_types(doubled=int)

        async def invoke(self, a: int) -> dict:
            await asyncio.sleep(0)
            return {"doubled": a * 2}

    return Doubler


def test_async_transformer_successful_results():
    ((rows),) = run_both(lambda pw: _doubler(pw)(pw.debug.table_from_markdown("a\n1\n2\n3")).successful)
    assert sorted(values(rows)) == [(2,), (4,), (6,)]


def _picky(pw):
    class Picky(pw.AsyncTransformer):
        output_schema = pw.schema_from_types(inv=float)

        async def invoke(self, a: int) -> dict:
            return {"inv": 1.0 / a}  # a=0 raises

    return Picky


def test_async_transformer_failures_route_to_failed_table():
    ((rows),) = run_both(lambda pw: _picky(pw)(pw.debug.table_from_markdown("a\n1\n0\n3")).successful)
    assert sorted(values(rows)) == [(1.0 / 3,), (1.0,)]

    def run(pw):
        tr = _picky(pw)(pw.debug.table_from_markdown("a\n1\n0"))
        cap_failed, cap_ok = tr.failed._capture_node(), tr.successful._capture_node()
        ctx = pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return len(ctx.state(cap_failed)["rows"]), [v[0] for v in ctx.state(cap_ok)["rows"].values()]

    assert both_equal(run) == (1, [1.0])


def test_async_transformer_with_retries_recovers():
    attempts: dict = {}

    def build(pw):
        attempts.clear()

        class Flaky(pw.AsyncTransformer):
            output_schema = pw.schema_from_types(v=int)

            async def invoke(self, a: int) -> dict:
                attempts[a] = attempts.get(a, 0) + 1
                if attempts[a] == 1:
                    raise ValueError("first try fails")
                return {"v": a * 10}

        t = pw.debug.table_from_markdown("a\n5\n6")
        return Flaky(t).with_options(retry_strategy=pw.udfs.FixedDelayRetryStrategy(max_retries=3, delay_ms=1)).successful

    ((rows),) = run_both(build)
    assert sorted(values(rows)) == [(50,), (60,)] and all(n >= 2 for n in attempts.values())


def test_async_transformer_cache_dedupes_equal_rows():
    calls: list = []

    def build(pw):
        calls.clear()

        class Tracked(pw.AsyncTransformer):
            output_schema = pw.schema_from_types(v=int)

            async def invoke(self, a: int) -> dict:
                calls.append(a)
                return {"v": a + 1}

        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(7,), (7,), (8,)])
        return Tracked(t).with_options(cache_strategy=pw.udfs.InMemoryCache()).successful

    ((rows),) = run_both(build)
    assert sorted(values(rows)) == [(8,), (8,), (9,)] and sorted(calls) == [7, 8]


def _collatz_step(pw, state):
    return state.select(n=pw.if_else(state.n == 1, 1, pw.if_else(state.n % 2 == 0, state.n // 2, 3 * state.n + 1)))


def test_iterate_collatz_reaches_one():
    def build(pw):
        t = pw.debug.table_from_markdown("n\n6\n7\n27")
        return pw.iterate(lambda state: _collatz_step(pw, state), state=t.select(n=t.n))

    ((rows),) = run_both(build)
    assert sorted(values(rows)) == [(1,), (1,), (1,)]


def test_iterate_fixed_point():
    def build(pw):
        t = pw.debug.table_from_markdown("x\n5\n16")
        return pw.iterate(lambda x: x.select(x=pw.apply(
            lambda v: 1 if v == 1 else (v // 2 if v % 2 == 0 else 3 * v + 1), pw.this.x)), x=t)

    ((rows),) = run_both(build)
    assert values(rows) == [(1,), (1,)]


@pytest.mark.parametrize("name", ["n", "x"])
def test_iterate_limit_stops_early(name):
    """``iteration_limit`` stops a body that never converges (the ``n``
    form of ``test_async_iterate.py``, the ``x`` form of
    ``test_stdlib_misc.py``)."""

    def build(pw):
        t = pw.debug.table_from_markdown(f"{name}\n0")
        return pw.iterate(lambda **kw: kw[name].select(**{name: kw[name][name] + 1}), iteration_limit=5,
                          **{name: t.select(**{name: t[name]})})

    ((rows),) = run_both(build)
    assert values(rows) == [(5,)]


def test_iterate_multi_table_fixed_point():
    def build(pw):
        t = pw.debug.table_from_markdown("g | v\nx | 1\nx | 9\nx | 4")

        def spread(state):
            m = state.groupby(state.g).reduce(state.g, mx=pw.reducers.max(state.v))
            return state.join(m, state.g == m.g).select(state.g, v=pw.right.mx)

        return pw.iterate(spread, state=t.select(t.g, t.v))

    ((rows),) = run_both(build)
    assert sorted(values(rows)) == [("x", 9), ("x", 9), ("x", 9)]


def test_iterate_records_its_rounds():
    """The port's ``IterateNode`` records the inner rounds of each solve
    (phase 19 prints them for Bellman-Ford)."""
    from pathway_tpu_torch.internals.iterate import IterateNode

    t = tpw.debug.table_from_markdown("n\n0")
    out = tpw.iterate(lambda state: state.select(n=state.n + 1), iteration_limit=5, state=t.select(n=t.n))
    tpw.debug._run_capture(out)
    (node,) = [n for n in tpw.G.engine_graph.nodes if isinstance(n, IterateNode)]
    assert node.rounds == [5]


# ---------------------------------------------------------------------------
# universes (tests/test_stdlib_misc.py:433)


def test_universe_promises():
    def build(pw):
        t1 = pw.debug.table_from_markdown("a\n1\n2")
        t2 = t1.filter(pw.this.a > 1)
        t3 = pw.universes.promise_is_subset_of(t2, t1)
        return t1.select(a=pw.this.a, b=t3.a)

    ((rows),) = run_both(build)
    assert (2, 2) in values(rows)


# ---------------------------------------------------------------------------
# phase 19's graph at a tiny width


TINY = {"docs": 512, "labelled": 384, "questions": 64, "graph": 128, "commit": 64}


def stdlib_tiny(pw, tiny, data: dict, optimize: int) -> tuple:
    """``chip_smoke.stdlib_graph`` in package ``pw`` over the tiny encoder:
    each sink's final rows, the embedder, the two indexes' stored vectors
    and the iterate node's rounds."""
    ext = import_module(f"{pw.__name__}.engine.external_index").ExternalIndexNode
    iterate_node = import_module(f"{pw.__name__}.internals.iterate").IterateNode
    pw.G.clear()
    emb = embedder(pw, tiny, batch=64)
    sinks = chip_smoke.stdlib_graph(pw, emb, tiny[0].hidden, data, TINY["graph"], knn(pw), commit=TINY["commit"])
    pw.run(monitoring_level=pw.MonitoringLevel.NONE, optimize=optimize)
    nodes = pw.G.engine_graph.nodes
    adapters = sorted((n.adapter for n in nodes if isinstance(n, ext)), key=lambda a: -len(a.index))
    for a in adapters:
        a.index.merge(wait=True)
    stored = [chip_smoke.index_vectors(np, a) for a in adapters]
    rounds = [getattr(n, "rounds", None) for n in nodes if isinstance(n, iterate_node)]
    pw.G.clear()
    return sinks, emb, stored, rounds


def rows_by(sink, key: str) -> dict:
    return {row[key]: row for row in sink.rows()}


def test_phase19_graph_matches_jax_at_a_tiny_width(tiny_encoder):
    """Predictions, window and join counts equal; edges by ids, distances
    within ``F32_TOL``; ranks and Bellman-Ford distances within
    ``F32_TOL`` (sums of those distances); the port at ``optimize`` 0 and 2
    the same; the port's run passes phase 19's own checks."""
    data = chip_smoke.stdlib_data(np, TINY["docs"], TINY["labelled"], TINY["questions"], chip_smoke.SEED)
    jax_sinks, _, _, _ = stdlib_tiny(jpw, tiny_encoder, data, 2)
    runs = {level: stdlib_tiny(tpw, tiny_encoder, data, level) for level in (0, 2)}
    for level, (sinks, emb, (stored, graph_stored), rounds) in runs.items():
        assert rows_by(sinks["predictions"], "doc") == rows_by(jax_sinks["predictions"], "doc"), level
        for name in ("windows", "join"):
            assert sorted(map(repr, sinks[name].rows())) == sorted(map(repr, jax_sinks[name].rows())), (name, level)
        got = sorted((e["u"], e["v"], e["dist"]) for e in sinks["edges"].rows())
        want = sorted((e["u"], e["v"], e["dist"]) for e in jax_sinks["edges"].rows())
        assert [e[:2] for e in got] == [e[:2] for e in want], level
        np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want], rtol=0, atol=F32_TOL)
        for name, key, col in (("ranks", "w", "rank"), ("distances", "doc", "dist")):
            g, w = rows_by(sinks[name], key), rows_by(jax_sinks[name], key)
            assert g.keys() == w.keys(), (name, level)
            np.testing.assert_allclose([g[k][col] for k in sorted(g)], [w[k][col] for k in sorted(g)],
                                       rtol=0, atol=F32_TOL)
        assert len(rounds) == 1 and rounds[0] and all(r >= 2 for r in rounds[0])
        checked = chip_smoke.stdlib_check(np, data, sinks, stored, graph_stored, emb.seen)
        assert checked["failed"] == [], checked["failed"]
        assert checked["classify_wrong"] == 0 and len(graph_stored) == TINY["graph"]
    assert [sorted(map(repr, runs[0][0][n].rows())) for n in runs[0][0]] == \
        [sorted(map(repr, runs[2][0][n].rows())) for n in runs[2][0]]
