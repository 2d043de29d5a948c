"""The port's ``pw.sql`` (``pathway_tpu_torch/internals/sql.py``) against
the JAX package's, on the CPU.

Every ``sql`` case of ``tests/test_stdlib_misc.py`` and the SQL property
cases of ``tests/test_property_sql_airbyte.py`` is written once, as a
function of the package module, and runs through both packages with the
same inputs: the result rows are equal as multisets (row ids are not
compared: a derived table keys its rows by the plan that made it), and the
JAX test's own expected rows hold on the port's output.  Where the
statement is in sqlite's dialect it also runs in the standard library's
``sqlite3`` over the same rows, and the answers are equal.
"""

from __future__ import annotations

import collections
import random
import sqlite3

import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw


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


def rows_of(pw, table) -> list[tuple]:
    """A table's final rows as value tuples, sorted by repr."""
    (rows, _), = pw.debug._run_capture(table)
    return sorted((tuple(v) for v in rows.values()), key=repr)


def both(build) -> list:
    """``build(pw)`` -> a list of tables, through each package: the rows of
    each table, equal as multisets in both; the port's rows."""
    out = {}
    for pw in (jpw, tpw):
        pw.G.clear()
        out[pw] = [rows_of(pw, t) for t in build(pw)]
        pw.G.clear()
    assert len(out[jpw]) == len(out[tpw])
    for want, got in zip(out[jpw], out[tpw]):
        assert collections.Counter(got) == collections.Counter(want)
    return out[tpw]


def in_sqlite(statement: str, tables: dict) -> list[tuple]:
    """``statement`` in sqlite3 over ``tables`` (name -> (columns, rows))."""
    db = sqlite3.connect(":memory:")
    for name, (cols, rows) in tables.items():
        db.execute(f"CREATE TABLE {name} ({', '.join(cols)})")
        db.executemany(f"INSERT INTO {name} VALUES ({', '.join('?' * len(cols))})", rows)
    got = db.execute(statement).fetchall()
    db.close()
    return sorted(got, key=repr)


def table(pw, cols: dict, rows: list[tuple]):
    return pw.debug.table_from_rows(pw.schema_from_types(**cols), rows)


# ---------------------------------------------------------------------------
# tests/test_stdlib_misc.py's sql cases

AB = ({"a": int, "b": int}, [(1, 10), (2, 20), (3, 30)])
PETS = ({"owner": str, "pets": int}, [("alice", 1), ("bob", 2), ("alice", 3)])


def test_sql_select_where():
    statement = "SELECT a, b FROM tab WHERE b > 15"
    (got,) = both(lambda pw: [pw.sql(statement, tab=table(pw, *AB))])
    assert got == [(2, 20), (3, 30)]
    assert got == in_sqlite(statement, {"tab": (list(AB[0]), AB[1])})


def test_sql_group_by():
    statement = "SELECT owner, SUM(pets) AS total, COUNT(*) AS n FROM t GROUP BY owner"
    (got,) = both(lambda pw: [pw.sql(statement, t=table(pw, *PETS))])
    assert got == [("alice", 4, 2), ("bob", 2, 1)]
    assert got == in_sqlite(statement, {"t": (list(PETS[0]), PETS[1])})


def test_sql_having_restated_aggregate():
    statement = "SELECT owner, SUM(pets) AS total FROM t GROUP BY owner HAVING SUM(pets) > 2"
    (got,) = both(lambda pw: [pw.sql(statement, t=table(pw, *PETS))])
    assert got == [("alice", 4)]
    assert got == in_sqlite(statement, {"t": (list(PETS[0]), PETS[1])})


def test_sql_distinct_union_subquery():
    t = ({"a": int, "b": str}, [(1, "x"), (1, "x"), (2, "y")])
    statements = [
        "SELECT DISTINCT a, b FROM t",
        "SELECT a FROM t WHERE b = 'x' UNION SELECT a FROM t WHERE a = 2",
        "SELECT a FROM t WHERE a = 2 UNION ALL SELECT a FROM t WHERE a = 2",
        "SELECT big.a AS a FROM (SELECT a FROM t WHERE a > 1) AS big",
    ]

    def build(pw):
        tab = table(pw, *t)
        return [pw.sql(s, t=tab) for s in statements]

    got = both(build)
    assert got == [[(1, "x"), (2, "y")], [(1,), (2,)], [(2,), (2,)], [(2,)]]
    for s, rows in zip(statements, got):
        assert rows == in_sqlite(s, {"t": (list(t[0]), t[1])}), s


def test_sql_cte_case_in_between_like_null():
    t = ({"name": str, "score": int}, [("ann", 10), ("bob", 25), ("carol", 40)])
    t2 = ({"v": int, "w": str | None}, [(1, None), (2, "x")])
    on_t = [
        """
        WITH ranked AS (
            SELECT name,
                   CASE WHEN score >= 30 THEN 'high'
                        WHEN score BETWEEN 15 AND 30 THEN 'mid'
                        ELSE 'low' END AS tier
            FROM t
        )
        SELECT name, tier FROM ranked WHERE tier IN ('high', 'mid')
        """,
        "SELECT name FROM t WHERE name LIKE 'c%l'",
        "SELECT name FROM t WHERE name NOT LIKE '%o%'",
    ]
    on_t2 = [
        "SELECT v FROM t2 WHERE w IS NULL",
        "SELECT v FROM t2 WHERE w IS NOT NULL",
        "SELECT v FROM t2 WHERE w NOT LIKE 'z%'",
        "SELECT v FROM t2 WHERE w NOT IN ('zzz')",
    ]

    def build(pw):
        a, b = table(pw, *t), table(pw, *t2)
        return [pw.sql(s, t=a) for s in on_t] + [pw.sql(s, t2=b) for s in on_t2]

    got = both(build)
    assert got == [[("bob", "mid"), ("carol", "high")], [("carol",)], [("ann",)],
                   [(1,)], [(2,)], [(2,)], [(2,)]]
    tables = {"t": (list(t[0]), t[1]), "t2": (list(t2[0]), t2[1])}
    for s, rows in zip(on_t + on_t2, got):
        assert rows == in_sqlite(s, tables), s


def test_sql_join():
    a = ({"k": int, "va": str}, [(1, "x"), (2, "y")])
    b = ({"k2": int, "vb": str}, [(1, "p"), (2, "q")])
    statement = "SELECT va, vb FROM a JOIN b ON a.k = b.k2"
    (got,) = both(lambda pw: [pw.sql(statement, a=table(pw, *a), b=table(pw, *b))])
    assert got == [("x", "p"), ("y", "q")]
    assert got == in_sqlite(statement, {"a": (list(a[0]), a[1]), "b": (list(b[0]), b[1])})


def test_sql_intersect_except():
    a = ({"x": int, "y": str}, [(1, "p"), (2, "q"), (2, "q"), (3, "r")])
    b = ({"x": int, "y": str}, [(2, "q"), (3, "r"), (4, "s")])
    statements = [
        "SELECT x, y FROM a INTERSECT SELECT x, y FROM b",
        "SELECT x, y FROM a EXCEPT SELECT x, y FROM b",
        "SELECT x, y FROM a EXCEPT SELECT x, y FROM b WHERE x = 3",
        # INTERSECT binds tighter than UNION in the standard (sqlite runs
        # compound selects left to right, so this one is not held to it)
        "SELECT x FROM a UNION SELECT x FROM b INTERSECT SELECT x FROM b WHERE x = 4",
    ]

    def build(pw):
        ta, tb = table(pw, *a), table(pw, *b)
        return [pw.sql(s, a=ta, b=tb) for s in statements]

    got = both(build)
    assert got == [[(2, "q"), (3, "r")], [(1, "p")], [(1, "p"), (2, "q")], [(1,), (2,), (3,), (4,)]]
    tables = {"a": (list(a[0]), a[1]), "b": (list(b[0]), b[1])}
    for s, rows in zip(statements[:3], got[:3]):
        assert rows == in_sqlite(s, tables), s


def test_sql_in_subquery():
    orders = ({"cust": str, "amount": int}, [("ann", 10), ("bob", 25), ("carol", 40), ("dave", 5)])
    vips = ({"name": str}, [("bob",), ("carol",)])
    statements = [
        "SELECT cust, amount FROM o WHERE cust IN (SELECT name FROM v)",
        "SELECT cust, amount FROM o WHERE cust NOT IN (SELECT name FROM v)",
        "SELECT cust FROM o WHERE amount > 7 AND cust IN (SELECT name FROM v)",
        "SELECT cust FROM o WHERE cust IN (SELECT name FROM v WHERE name = 'bob')",
    ]

    def build(pw):
        o, v = table(pw, *orders), table(pw, *vips)
        vd = v.groupby(v.name).reduce(v.name)
        gt = o.join(vd, o.cust == vd.name).select(pw.left.cust, pw.left.amount)
        return [pw.sql(s, o=o, v=v) for s in statements] + [gt]

    got = both(build)
    assert got[:4] == [[("bob", 25), ("carol", 40)], [("ann", 10), ("dave", 5)], [("bob",), ("carol",)],
                       [("bob",)]]
    assert got[0] == got[4]  # the semi-join's ground truth through table ops
    tables = {"o": (list(orders[0]), orders[1]), "v": (list(vips[0]), vips[1])}
    for s, rows in zip(statements, got):
        assert rows == in_sqlite(s, tables), s


# ---------------------------------------------------------------------------
# tests/test_property_sql_airbyte.py's SQL cases


def _rand_rows(rng: random.Random, n: int, vals: int) -> list[tuple]:
    return [(rng.randrange(vals), rng.choice(["p", "q", "r"])) for _ in range(n)]


XY = {"x": int, "y": str}


@pytest.mark.parametrize("seed", range(8))
def test_sql_set_ops_match_set_semantics(seed):
    rng = random.Random(seed)
    rows_a = _rand_rows(rng, rng.randrange(0, 14), 5)
    rows_b = _rand_rows(rng, rng.randrange(0, 14), 5)
    statements = [
        "SELECT x, y FROM a INTERSECT SELECT x, y FROM b",
        "SELECT x, y FROM a EXCEPT SELECT x, y FROM b",
        "SELECT x, y FROM a UNION SELECT x, y FROM b",
        "SELECT x, y FROM a UNION ALL SELECT x, y FROM b",
    ]

    def build(pw):
        a, b = table(pw, XY, rows_a), table(pw, XY, rows_b)
        return [pw.sql(s, a=a, b=b) for s in statements]

    got = both(build)
    sa, sb = set(rows_a), set(rows_b)
    assert got[0] == sorted(sa & sb, key=repr)
    assert got[1] == sorted(sa - sb, key=repr)
    assert got[2] == sorted(sa | sb, key=repr)
    assert got[3] == sorted(rows_a + rows_b, key=repr)
    tables = {"a": (list(XY), rows_a), "b": (list(XY), rows_b)}
    for s, rows in zip(statements, got):
        assert rows == in_sqlite(s, tables), s


@pytest.mark.parametrize("seed", range(8))
def test_sql_in_subquery_matches_membership(seed):
    rng = random.Random(100 + seed)
    rows_a = _rand_rows(rng, rng.randrange(1, 14), 6)
    rows_b = _rand_rows(rng, rng.randrange(0, 10), 6)
    statements = [
        "SELECT x, y FROM a WHERE x IN (SELECT x FROM b)",
        "SELECT x, y FROM a WHERE x NOT IN (SELECT x FROM b)",
    ]

    def build(pw):
        a, b = table(pw, XY, rows_a), table(pw, XY, rows_b)
        return [pw.sql(s, a=a, b=b) for s in statements]

    got = both(build)
    members = {x for x, _y in rows_b}
    assert got[0] == sorted((r for r in rows_a if r[0] in members), key=repr)
    assert got[1] == sorted((r for r in rows_a if r[0] not in members), key=repr)
    tables = {"a": (list(XY), rows_a), "b": (list(XY), rows_b)}
    for s, rows in zip(statements, got):
        assert rows == in_sqlite(s, tables), s


def test_sql_in_subquery_null_handling_matches_documented_contract():
    """A NULL probe never matches (IN and NOT IN both drop it); a NULL
    inside the subquery is a non-matching value: the JAX package's
    documented contract, which departs from the standard (and sqlite)
    there, so sqlite holds only the IN form."""
    statements = [
        "SELECT x, y FROM a WHERE x IN (SELECT x FROM b)",
        "SELECT x, y FROM a WHERE x NOT IN (SELECT x FROM b)",
    ]
    rows_a = [(1, "p"), (2, "q"), (None, "n")]
    rows_b = [(1,), (None,)]

    def build(pw):
        a = table(pw, {"x": int | None, "y": str}, rows_a)
        b = table(pw, {"x": int | None}, rows_b)
        return [pw.sql(s, a=a, b=b) for s in statements]

    got = both(build)
    assert got == [[(1, "p")], [(2, "q")]]
    assert got[0] == in_sqlite(statements[0], {"a": (["x", "y"], rows_a), "b": (["x"], rows_b)})


def test_sql_set_ops_precedence_and_chaining():
    """A UNION B EXCEPT C runs left to right; INTERSECT binds tighter than
    UNION (sqlite runs every compound left to right, so it holds the
    first)."""
    a, b, c = [(1, "p"), (2, "p")], [(2, "p"), (3, "p")], [(3, "p")]
    statements = [
        "SELECT x, y FROM a UNION SELECT x, y FROM b EXCEPT SELECT x, y FROM c",
        "SELECT x, y FROM a UNION SELECT x, y FROM b INTERSECT SELECT x, y FROM c",
    ]

    def build(pw):
        ta, tb, tc = table(pw, XY, a), table(pw, XY, b), table(pw, XY, c)
        return [pw.sql(s, a=ta, b=tb, c=tc) for s in statements]

    got = both(build)
    assert got == [[(1, "p"), (2, "p")], [(1, "p"), (2, "p"), (3, "p")]]
    tables = {"a": (list(XY), a), "b": (list(XY), b), "c": (list(XY), c)}
    assert got[0] == in_sqlite(statements[0], tables)
