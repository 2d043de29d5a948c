"""The port's engine core (``pathway_tpu_torch``'s Table API, scheduler and
native module) against the JAX package's, on the CPU.

Each pipeline is written once, as a function of the package module
(``build(pw)``), and runs through ``pathway_tpu`` and through
``pathway_tpu_torch``.  Both runs are captured with ``pw.debug``'s
capture (the final rows by id, and the update stream in the order the
engine emitted it) and must be equal: ids as integers (a ``Pointer`` is
an ``int``), a ``Json`` by its value, an ``Error`` as the error, a numpy
array by its type and values.  Ids come from the same type-tagged
BLAKE2b keys on both sides, so they must agree bit for bit.  The native
module is checked to be the port's own build, registering the port's
classes; a pipeline run with ``PATHWAY_DISABLE_NATIVE=1`` (the Python
fallback) must equal the native run.  The embedder UDF is held against
the JAX embedder in ``tests/test_torch_engine_udf.py``.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import native as port_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def norm(v):
    """A value in a form both packages' values compare in."""
    if type(v).__name__ == "_Error":
        return ("Error",)
    if type(v).__name__ == "Pointer":
        return ("Pointer", int(v))
    if type(v).__name__ == "Json":
        return ("Json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tolist())
    if isinstance(v, tuple):
        return tuple(norm(x) for x in v)
    return v


def capture(pw, build) -> list:
    """``build(pw)``'s tables run through ``pw.debug``: per table, its rows
    by id and its update stream, normalised."""
    pw.G.clear()
    tables = build(pw)
    tables = tables if isinstance(tables, tuple) else (tables,)
    out = []
    for rows, stream in pw.debug._run_capture(*tables):
        out.append((
            {int(k): norm(tuple(v)) for k, v in rows.items()},
            [(int(k), norm(tuple(v)), t, d) for k, v, t, d in stream],
        ))
    pw.G.clear()
    return out


# ---------------------------------------------------------------------------
# The pipelines, each written once as a function of the package module


def first_target(pw):
    """ROADMAP item 12's first target: markdown -> groupby -> reduce."""
    t = pw.debug.table_from_markdown(
        """
        word  | cnt
        apple | 1
        pear  | 2
        apple | 3
        plum  | 5
        pear  | 7
        """
    )
    return t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.cnt), n=pw.reducers.count())


def select_arith_casts_str_dt(pw):
    t = pw.debug.table_from_markdown(
        """
        a  | b   | s               | d
        3  | 2.5 | '  Hello World' | '2023-03-25 14:30:45'
        -7 | 0.5 | 'abc'           | '2024-02-29 00:00:01'
        10 | 4.0 | 'MiXeD case'    | '1999-12-31 23:59:59'
        """
    )
    p = t.select(
        t.a,
        lin=t.a * 2 + 1,
        fdiv=t.a // 3,
        mod=t.a % 3,
        half=t.b / 2,
        sq=t.a ** 2,
        neg=-t.a,
        mix=t.a * t.b - 1.5,
        cmp=(t.a > 0) & (t.b < 3.0),
        af=pw.cast(float, t.a),
        bi=pw.cast(int, t.b),
        up=t.s.str.upper(),
        low=t.s.str.lower(),
        n=t.s.str.len(),
        strip=t.s.str.strip(),
        rev=t.s.str.reversed(),
        find=t.s.str.find("l"),
        starts=t.s.str.startswith("a"),
        title=t.s.str.title(),
        d=t.d.str.parse_datetime("%Y-%m-%d %H:%M:%S"),
    )
    return p.select(
        *[p[c] for c in p.column_names() if c != "d"],
        y=p.d.dt.year(),
        mo=p.d.dt.month(),
        dow=p.d.dt.day_of_week(),
        doy=p.d.dt.day_of_year(),
        fmt=p.d.dt.strftime("%d/%m/%Y %H"),
        floor=p.d.dt.floor(datetime.timedelta(hours=1)),
        later=p.d + datetime.timedelta(days=1, seconds=30),
        ts=p.d.dt.timestamp(unit="s"),
    )


def filter_and_if_else(pw):
    t = pw.debug.table_from_markdown(
        """
        name  | age | score
        Alice | 30  | 7.5
        Bob   | 17  | 9.0
        Carol | 45  | 3.25
        Dan   | 12  | 8.0
        Eve   | 60  | 5.5
        """
    )
    adults = t.filter(t.age >= 18)
    return adults.select(
        adults.name,
        band=pw.if_else(adults.age > 40, "senior", "adult"),
        bonus=pw.if_else(adults.score > 5.0, adults.score * 2, 0.0),
        tag=pw.make_tuple(adults.name, adults.age),
    ).filter(pw.this.bonus >= 0.0)


def reducers_matrix(pw):
    """Every reducer of ``tests/test_reducers_matrix.py``."""
    t = pw.debug.table_from_rows(
        pw.schema_from_types(g=str, v=int, w=float),
        [("x", 3, 1.0), ("x", 1, 2.0), ("x", 2, 4.0), ("y", 10, 0.5), ("z", 4, 4.0), ("z", 4, 1.5)],
    )
    arrays = pw.debug.table_from_rows(
        pw.schema_from_types(g=str, vec=object),
        [("x", np.array([1.0, 2.0])), ("x", np.array([3.0, 4.0])), ("y", np.array([0.5, -1.0]))],
    )
    concat = pw.reducers.stateful_single(lambda state, val: (state or 0) * 10 + val)
    numeric = t.groupby(t.g).reduce(
        t.g,
        n=pw.reducers.count(),
        s=pw.reducers.sum(t.v),
        a=pw.reducers.avg(t.w),
        lo=pw.reducers.min(t.v),
        hi=pw.reducers.max(t.v),
        am=pw.reducers.argmax(t.v, t.w),
        an=pw.reducers.argmin(t.v, t.w),
        st=pw.reducers.sorted_tuple(t.v),
        tp=pw.reducers.tuple(t.w),
        u=pw.reducers.unique(t.v),
        anyv=pw.reducers.any(t.v),
        c=concat(t.v),
    )
    vectors = arrays.groupby(arrays.g).reduce(
        arrays.g, total=pw.reducers.npsum(arrays.vec), stacked=pw.reducers.ndarray(arrays.vec)
    )
    return numeric, vectors


def reducers_over_time(pw):
    """earliest/latest and every extreme under retraction."""
    t = pw.debug.table_from_markdown(
        """
        g | v | __time__ | __diff__
        x | 1 | 2        | 1
        x | 9 | 2        | 1
        y | 4 | 2        | 1
        x | 9 | 4        | -1
        x | 5 | 4        | 1
        y | 6 | 6        | 1
        y | 4 | 8        | -1
        """
    )
    return t.groupby(t.g).reduce(
        t.g,
        first=pw.reducers.earliest(t.v),
        last=pw.reducers.latest(t.v),
        hi=pw.reducers.max(t.v),
        lo=pw.reducers.min(t.v),
        s=pw.reducers.sum(t.v),
        st=pw.reducers.sorted_tuple(t.v),
    )


def _join_inputs(pw):
    left = pw.debug.table_from_markdown(
        """
        k | x
        1 | a
        2 | b
        2 | bb
        4 | d
        """
    )
    right = pw.debug.table_from_markdown(
        """
        k | y
        2 | 20
        3 | 30
        4 | 40
        4 | 41
        """
    )
    return left, right


def join_inner(pw):
    left, right = _join_inputs(pw)
    return left.join(right, left.k == right.k).select(left.k, left.x, right.y)


def join_left(pw):
    left, right = _join_inputs(pw)
    return left.join_left(right, left.k == right.k).select(left.k, left.x, right.y)


def join_outer(pw):
    left, right = _join_inputs(pw)
    return left.join_outer(right, left.k == right.k).select(
        k=pw.coalesce(left.k, right.k), x=left.x, y=right.y
    )


def ix_concat_update_rows(pw):
    people = pw.debug.table_from_markdown(
        """
        name  | age
        Alice | 30
        Bob   | 17
        Carol | 45
        """
    ).with_id_from(pw.this.name)
    asks = pw.debug.table_from_markdown(
        """
        who
        Carol
        Alice
        """
    )
    looked_up = asks.select(asks.who, age=people.ix(people.pointer_from(asks.who)).age)
    more = pw.debug.table_from_markdown(
        """
        name | age
        Zed  | 70
        """
    ).with_id_from(pw.this.name)
    both = people.concat_reindex(more)
    patch = pw.debug.table_from_markdown(
        """
        name | age
        Bob  | 18
        Zed  | 71
        """
    ).with_id_from(pw.this.name)
    updated = people.update_rows(patch).with_columns(older=pw.this.age + 1)
    return looked_up, both, updated


def row_transformer(pw):
    prices = pw.debug.table_from_markdown(
        """
        product | price
        apple   | 10.0
        pear    | 20.0
        """
    ).with_id_from(pw.this.product)
    orders = pw.debug.table_from_markdown(
        """
        product | qty
        apple   | 3
        pear    | 2
        apple   | 5
        """
    )
    orders = orders.select(product=prices.pointer_from(orders.product), qty=orders.qty)

    @pw.transformer
    class pricing:
        class products(pw.ClassArg):
            price = pw.input_attribute()

            @pw.output_attribute
            def doubled(self):
                return self.price * 2

        class orders(pw.ClassArg):
            product = pw.input_attribute()
            qty = pw.input_attribute()

            @pw.output_attribute
            def total(self):
                return self.transformer.products[self.product].price * self.qty

    res = pricing(products=prices, orders=orders)
    return res.products, res.orders


def error_values(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b | s
        6 | 3 | 12
        1 | 0 | x
        8 | 2 | 7
        """
    )
    p = t.select(t.a, q=t.a // t.b, r=t.a / t.b, n=pw.cast(int, t.s))
    return p.select(p.a, q=pw.fill_error(p.q, -1), r=p.r, n=p.n, ok=pw.fill_error(p.n, 0) + 1)


def update_stream(pw):
    t = pw.debug.table_from_markdown(
        """
        k | v  | __time__ | __diff__
        a | 1  | 2        | 1
        b | 2  | 2        | 1
        a | 1  | 4        | -1
        a | 5  | 4        | 1
        c | 7  | 6        | 1
        b | 2  | 8        | -1
        """
    )
    sums = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v), n=pw.reducers.count())
    return sums, t.filter(t.v > 1).select(t.k, w=t.v * 10)


def plain_udf(pw):
    @pw.udf
    def shout(word: str, times: int) -> str:
        return (word.upper() + "!") * times

    @pw.udf(deterministic=True)
    def halve(x: float) -> float:
        return x / 2

    t = pw.debug.table_from_markdown(
        """
        w     | n | f
        hi    | 1 | 3.0
        there | 2 | 5.0
        you   | 3 | -1.0
        """
    )
    return t.select(t.w, loud=shout(t.w, t.n), h=halve(t.f))


def batched_udf(pw):
    class Lengths(pw.UDF):
        """A ``__batch__`` UDF that records the batch sizes it is handed."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.calls: list[int] = []

        def __batch__(self, words: list, offsets: list) -> list:
            self.calls.append(len(words))
            return [len(w) + o for w, o in zip(words, offsets)]

        def __wrapped__(self, word: str, offset: int) -> int:
            return len(word) + offset

    t = pw.debug.table_from_rows(
        pw.schema_from_types(word=str, off=int), [(f"w{'x' * i}", i % 3) for i in range(11)]
    )
    whole, chunked = Lengths(), Lengths(max_batch_size=4)
    return t.select(t.word, n=whole(t.word, t.off)), t.select(t.word, n=chunked(t.word, t.off))


def json_pointer_dicts(pw):
    t = pw.debug.table_from_dicts(
        [
            {"doc": pw.Json({"a": 1, "b": [1, 2]}), "label": "one"},
            {"doc": pw.Json({"a": 2, "b": []}), "label": "two"},
            {"doc": pw.Json({"b": [3]}), "label": "three"},
        ]
    )
    return t.select(
        t.label,
        a=t.doc.get("a"),
        b=t.doc["b"],
        ptr=t.pointer_from(t.label),
        me=t.id,
    )


PIPELINES = [
    first_target,
    select_arith_casts_str_dt,
    filter_and_if_else,
    reducers_matrix,
    reducers_over_time,
    join_inner,
    join_left,
    join_outer,
    ix_concat_update_rows,
    row_transformer,
    error_values,
    update_stream,
    plain_udf,
    batched_udf,
    json_pointer_dicts,
]


@pytest.mark.parametrize("build", PIPELINES, ids=[p.__name__ for p in PIPELINES])
def test_pipeline_matches_jax_package(build):
    """Same ids and rows, and the same update stream, on both packages."""
    want = capture(jpw, build)
    got = capture(tpw, build)
    assert len(got) == len(want)
    for (grows, gstream), (wrows, wstream) in zip(got, want):
        assert wrows, f"{build.__name__}: the reference produced no rows"
        assert grows == wrows
        assert gstream == wstream


def test_update_stream_prints_the_same(capsys):
    """``compute_and_print_update_stream`` and ``compute_and_print`` print
    the same lines (ids, values, times and diffs) on both packages."""
    printed = []
    for pw in (jpw, tpw):
        pw.G.clear()
        sums, _ = update_stream(pw)
        pw.debug.compute_and_print_update_stream(sums)
        pw.G.clear()
        pw.debug.compute_and_print(first_target(pw))
        pw.G.clear()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "__time__" in printed[0] and "__diff__" in printed[0]


def test_batched_udf_is_chunked_by_max_batch_size():
    for pw in (jpw, tpw):
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i,) for i in range(10)])

        class Echo(pw.UDF):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.calls: list[int] = []

            def __batch__(self, xs: list) -> list:
                self.calls.append(len(xs))
                return list(xs)

        echo = Echo(max_batch_size=4)
        keys, cols = pw.debug.table_to_dicts(t.select(y=echo(t.x)))
        assert sorted(cols["y"].values()) == list(range(10))
        assert sorted(echo.calls) == [2, 4, 4], pw.__name__


# ---------------------------------------------------------------------------
# The native module


def test_native_module_is_the_ports_own_build():
    mod = port_native.load()
    assert mod is not None, "the port's native module did not build or load"
    assert mod.__name__ == "pathway_torch_native" == port_native.MODULE_NAME
    build_dir = os.path.join(REPO, "pathway_tpu_torch", "native", "build")
    assert os.path.dirname(os.path.abspath(mod.__file__)) == build_dir
    from pathway_tpu.internals import native as jax_native

    jmod = jax_native.load()
    assert jmod is not mod and jmod.__name__ == "pathway_native"
    assert os.path.dirname(os.path.abspath(jmod.__file__)) == os.path.join(REPO, "native", "build")


def test_native_module_registers_the_ports_classes():
    """The port's module hashes the port's ``Pointer`` with its type tag, so
    a key derived from a key is the same on the native and Python paths,
    and the same as the JAX package's; the JAX package's ``Pointer`` is
    not the type it registered."""
    from pathway_tpu.internals import keys as jkeys
    from pathway_tpu_torch.internals import keys

    mod = port_native.load()
    assert mod._json_registered
    base = keys.ref_scalar("row", 7)
    assert type(base) is keys.Pointer and int(base) == int(jkeys.ref_scalar("row", 7))
    args = ("child", base, 1.5, None, "é")
    native = mod.ref_scalar(*args)
    assert native == int(keys._py_ref_scalar(*args))
    assert native == int(jkeys.ref_scalar("child", jkeys.Pointer(int(base)), 1.5, None, "é"))
    try:
        foreign = mod.ref_scalar("child", jkeys.Pointer(int(base)), 1.5, None, "é")
    except mod.Unsupported:
        foreign = None
    assert foreign != native


NATIVE_OFF_SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import native
import test_torch_engine as m
out = {{}}
for build in (m.first_target, m.join_outer, m.reducers_over_time, m.error_values,
              m.select_arith_casts_str_dt, m.update_stream):
    out[build.__name__] = [
        [sorted(map(repr, rows.items())), sorted(map(repr, stream))] for rows, stream in m.capture(pw, build)
    ]
out["native"] = native.load() is not None
print(json.dumps(out))
"""


def test_native_off_run_equals_the_native_run():
    """The Python fallback (``PATHWAY_DISABLE_NATIVE=1``, in a subprocess)
    gives the same ids and rows as the native run, and the same updates at
    each time (the order of updates within one time is not part of a
    stream's meaning, and the native join emits them in another order)."""
    code = NATIVE_OFF_SCRIPT.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    runs = {}
    for flag in ("1", "0"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PATHWAY_DISABLE_NATIVE"] = flag
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        runs[flag] = json.loads(out.stdout.strip().splitlines()[-1])
    assert runs["1"].pop("native") is False and runs["0"].pop("native") is True
    assert runs["1"] == runs["0"]


def test_later_slices_raise_naming_their_item():
    for name, item in (("temporal", "item 16"), ("persistence", "item 16"),
                       ("analysis", "item 16"), ("iterate", "item 16"), ("sql", "item 16")):
        with pytest.raises(AttributeError, match=item):
            getattr(tpw, name)
    # item 15 brought the connectors and ``stdlib.utils``: ``io``, ``utils``
    # and ``AsyncTransformer`` resolve; an unported connector and the
    # parsers still to come name the item that brings them
    assert tpw.io.fs.__name__ == "pathway_tpu_torch.io.fs"
    assert tpw.utils is tpw.stdlib.utils
    assert tpw.AsyncTransformer is tpw.stdlib.utils.AsyncTransformer
    with pytest.raises(AttributeError, match="item 16"):
        tpw.io.kafka  # noqa: B018
    for parser in ("ParseUnstructured", "ParseHtml", "ParseDocx", "PypdfParser", "ImageParser",
                   "SlideParser", "OpenParse"):
        with pytest.raises(AttributeError, match="item 16"):
            getattr(tpw.xpacks.llm.parsers, parser)
    # item 14 brought the indexes: ``indexing`` and ``stdlib`` resolve, and
    # the stdlib's other submodules name the item that brings them
    assert tpw.indexing is tpw.stdlib.indexing
    assert tpw.indexing.BruteForceKnnFactory.__module__ == "pathway_tpu_torch.stdlib.indexing.data_index"
    for name in ("temporal", "ml", "graphs", "stateful", "statistical", "ordered", "viz"):
        with pytest.raises(AttributeError, match="item 16"):
            getattr(tpw.stdlib, name)
    with pytest.raises(AttributeError, match="no attribute 'nonsense'"):
        tpw.nonsense  # noqa: B018
    with pytest.raises(NotImplementedError, match="item 16"):
        tpw.run(persistence_config=object())
    with pytest.raises(NotImplementedError, match="item 16"):
        tpw.run(strict=True)
    assert tpw.DateTimeNaive is tpw.internals.dtype.DateTimeNaive
    assert tpw.xpacks.llm.embedders.TorchEncoderEmbedder is tpw.TorchEncoderEmbedder


def test_public_names_match_the_jax_package():
    """Every name in the JAX package's ``__all__`` exists in the port or is
    one that a later slice brings (and raises saying so)."""
    later = set(tpw._LATER)
    missing = [n for n in jpw.__all__ if n not in later and not hasattr(tpw, n)]
    assert missing == []
    assert set(jpw.__all__) - later <= set(tpw.__all__)
