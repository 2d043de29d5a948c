"""``pw.sql(query, **tables)`` — SQL over Tables (reference
``internals/sql.py``, 726 LoC, built on SQLGlot).

SQLGlot isn't available in this environment, so this is a hand-rolled
translator for the practical subset: SELECT (expressions, aliases, *),
FROM, INNER/LEFT JOIN ... ON equalities, WHERE, GROUP BY, HAVING, and
the SUM/COUNT/AVG/MIN/MAX aggregates.  Produces the same incremental
Table operations a hand-written pipeline would.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, _wrap
from pathway_tpu_torch.internals.table import Table

__all__ = ["sql"]

_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)"
    r"|(?P<str>'[^']*')"
    r'|(?P<qname>"[^"]*")'  # quoted identifier: never a keyword
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.))"
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "as", "join",
    "inner", "left", "right", "outer", "on", "and", "or", "not", "union",
    "all", "distinct", "with", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "true", "false", "intersect",
    "except",
}

_AGGS = {"sum", "count", "avg", "min", "max"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise ValueError(f"SQL syntax error near: {src[pos:pos+30]!r}")
        pos = m.end()
        for kind in ("num", "str", "qname", "name", "op"):
            v = m.group(kind)
            if v is not None:
                if kind == "qname":
                    out.append(("name", v[1:-1]))  # "end" -> plain identifier
                elif kind == "name" and v.lower() in _KEYWORDS:
                    out.append(("kw", v.lower()))
                else:
                    out.append((kind, v))
                break
    out.append(("end", ""))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def at_kw(self, *kws: str) -> bool:
        k, v = self.peek()
        return k == "kw" and v in kws

    def eat(self, kind=None, value=None):
        k, v = self.toks[self.i]
        if (kind and k != kind) or (value and v != value):
            raise ValueError(f"unexpected {v!r} (wanted {value or kind})")
        self.i += 1
        return v

    # ---- expressions (AST: tuples) ----
    def expr(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.at_kw("or"):
            self.eat()
            left = ("or", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.at_kw("and"):
            self.eat()
            left = ("and", left, self._not())
        return left

    def _not(self):
        if self.at_kw("not"):
            self.eat()
            return ("not", self._not())
        return self._cmp()

    def _cmp(self):
        left = self._add()
        k, v = self.peek()
        if k == "op" and v in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.eat()
            return ("cmp", v, left, self._add())
        negated = False
        if self.at_kw("not"):
            # NOT between a value and IN/BETWEEN/LIKE binds to the operator
            self.eat()
            negated = True
        if self.at_kw("in"):
            self.eat()
            self.eat("op", "(")
            if self.at_kw("select"):
                # IN (SELECT ...) — semi/anti-join subquery
                sub = self.select()
                self.eat("op", ")")
                return ("in_sub", left, sub, negated)
            vals = [self.expr()]
            while self.peek() == ("op", ","):
                self.eat()
                vals.append(self.expr())
            self.eat("op", ")")
            node = ("in", left, vals)
            return ("not", node) if negated else node
        if self.at_kw("between"):
            self.eat()
            lo = self._add()
            self.eat("kw", "and")
            hi = self._add()
            node = ("between", left, lo, hi)
            return ("not", node) if negated else node
        if self.at_kw("like"):
            self.eat()
            pat = self._add()
            node = ("like", left, pat)
            return ("not", node) if negated else node
        if negated:
            raise ValueError("NOT here must precede IN/BETWEEN/LIKE")
        if self.at_kw("is"):
            self.eat()
            neg = False
            if self.at_kw("not"):
                self.eat()
                neg = True
            self.eat("kw", "null")
            return ("isnull", left, neg)
        return left

    def _add(self):
        left = self._mul()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            op = self.eat()
            left = ("bin", op, left, self._mul())
        return left

    def _mul(self):
        left = self._atom()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%"):
            op = self.eat()
            left = ("bin", op, left, self._atom())
        return left

    def _atom(self):
        k, v = self.peek()
        if k == "op" and v == "(":
            self.eat()
            e = self.expr()
            self.eat("op", ")")
            return e
        if k == "op" and v == "-":
            self.eat()
            return ("neg", self._atom())
        if k == "kw" and v == "null":
            self.eat()
            return ("lit", None)
        if k == "kw" and v in ("true", "false"):
            self.eat()
            return ("lit", v == "true")
        if k == "kw" and v == "case":
            self.eat()
            whens = []
            while self.at_kw("when"):
                self.eat()
                cond = self.expr()
                self.eat("kw", "then")
                whens.append((cond, self.expr()))
            default = ("lit", None)
            if self.at_kw("else"):
                self.eat()
                default = self.expr()
            self.eat("kw", "end")
            return ("case", whens, default)
        if k == "num":
            self.eat()
            return ("lit", float(v) if "." in v else int(v))
        if k == "str":
            self.eat()
            return ("lit", v[1:-1])
        if k == "op" and v == "*":
            self.eat()
            return ("star",)
        if k == "name":
            self.eat()
            name = v
            if self.peek() == ("op", "("):
                self.eat()
                if self.peek() == ("op", "*"):
                    self.eat()
                    args: list = [("star",)]
                elif self.peek() == ("op", ")"):
                    args = []
                else:
                    args = [self.expr()]
                    while self.peek() == ("op", ","):
                        self.eat()
                        args.append(self.expr())
                self.eat("op", ")")
                return ("call", name.lower(), args)
            if self.peek() == ("op", "."):
                self.eat()
                col = self.eat("name")
                return ("col", name, col)
            return ("col", None, name)
        raise ValueError(f"unexpected token {v!r} in expression")

    # ---- statement ----
    def statement(self) -> dict:
        """Full statement: [WITH ctes] select [UNION [ALL] select]..."""
        ctes = []
        if self.at_kw("with"):
            self.eat()
            while True:
                name = self.eat("name")
                self.eat("kw", "as")
                self.eat("op", "(")
                ctes.append((name, self.select()))
                self.eat("op", ")")
                if self.peek() == ("op", ","):
                    self.eat()
                    continue
                break
        # set-op chain; INTERSECT binds tighter than UNION/EXCEPT (SQL
        # standard precedence), so parse intersect-chains as units
        def intersect_chain() -> dict | tuple:
            node: dict | tuple = self.select()
            while self.at_kw("intersect"):
                self.eat()
                node = ("intersect", node, self.select())
            return node

        first = intersect_chain()
        setops = []
        while self.at_kw("union", "except"):
            op = self.eat()
            all_ = False
            if op == "union" and self.at_kw("all"):
                self.eat()
                all_ = True
            setops.append((op, all_, intersect_chain()))
        self.eat("end")
        return {"ctes": ctes, "select": first, "setops": setops}

    def select(self) -> dict:
        self.eat("kw", "select")
        distinct = False
        if self.at_kw("distinct"):
            self.eat()
            distinct = True
        items = []
        while True:
            e = self.expr()
            alias = None
            if self.at_kw("as"):
                self.eat()
                alias = self.eat("name")
            elif self.peek()[0] == "name":
                alias = self.eat("name")
            items.append((e, alias))
            if self.peek() == ("op", ","):
                self.eat()
                continue
            break
        self.eat("kw", "from")
        if self.peek() == ("op", "("):
            # derived table: FROM (SELECT ...) [AS] alias
            self.eat()
            sub = self.select()
            self.eat("op", ")")
            if self.at_kw("as"):
                self.eat()
            table = ("subquery", sub, self.eat("name"))
        else:
            table = self.eat("name")
        joins = []
        while self.at_kw("join", "inner", "left", "right", "outer"):
            how = "inner"
            while self.at_kw("inner", "left", "right", "outer"):
                how = self.eat()
            self.eat("kw", "join")
            jt = self.eat("name")
            self.eat("kw", "on")
            cond = self.expr()
            joins.append((how, jt, cond))
        where = None
        if self.at_kw("where"):
            self.eat()
            where = self.expr()
        group_by = []
        if self.at_kw("group"):
            self.eat()
            self.eat("kw", "by")
            group_by.append(self.expr())
            while self.peek() == ("op", ","):
                self.eat()
                group_by.append(self.expr())
        having = None
        if self.at_kw("having"):
            self.eat()
            having = self.expr()
        return {
            "items": items,
            "table": table,
            "joins": joins,
            "where": where,
            "group_by": group_by,
            "having": having,
            "distinct": distinct,
        }


def _has_agg(ast) -> bool:
    if not isinstance(ast, tuple):
        return False
    if ast[0] == "call" and ast[1] in _AGGS:
        return True
    return any(_has_agg(c) for c in ast[1:] if isinstance(c, (tuple, list)))


class _Translator:
    def __init__(self, tables: dict[str, Table]):
        self.tables = tables

    def column(self, table_hint: str | None, name: str, scope: Table) -> ColumnExpression:
        if table_hint is not None:
            t = self.tables.get(table_hint)
            if t is None:
                raise KeyError(f"unknown table {table_hint!r}")
            return t[name]
        return scope[name]

    def to_expr(self, ast, scope: Table) -> Any:
        import pathway_tpu_torch as pw

        kind = ast[0]
        if kind == "lit":
            return ast[1]
        if kind == "col":
            return self.column(ast[1], ast[2], scope)
        if kind == "cmp":
            op, a, b = ast[1], self.to_expr(ast[2], scope), self.to_expr(ast[3], scope)
            a, b = _wrap(a), _wrap(b)
            return {
                "=": a == b, "!=": a != b, "<>": a != b,
                "<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
            }[op]
        if kind == "bin":
            op, a, b = ast[1], _wrap(self.to_expr(ast[2], scope)), _wrap(self.to_expr(ast[3], scope))
            return {"+": a + b, "-": a - b, "*": a * b, "/": a / b, "%": a % b}[op]
        if kind == "and":
            return _wrap(self.to_expr(ast[1], scope)) & _wrap(self.to_expr(ast[2], scope))
        if kind == "or":
            return _wrap(self.to_expr(ast[1], scope)) | _wrap(self.to_expr(ast[2], scope))
        if kind == "not":
            return ~_wrap(self.to_expr(ast[1], scope))
        if kind == "neg":
            return -_wrap(self.to_expr(ast[1], scope))
        if kind == "in":
            from pathway_tpu_torch.internals.expression import if_else

            e = _wrap(self.to_expr(ast[1], scope))
            out = None
            for v_ast in ast[2]:
                test = e == _wrap(self.to_expr(v_ast, scope))
                out = test if out is None else (out | test)
            # SQL three-valued logic: NULL IN (...) is NULL, so NOT IN
            # keeps excluding NULL rows (None drops in filters either way)
            return if_else(e.is_none(), _wrap(None), _wrap(out))
        if kind == "between":
            e = _wrap(self.to_expr(ast[1], scope))
            lo = _wrap(self.to_expr(ast[2], scope))
            hi = _wrap(self.to_expr(ast[3], scope))
            return (e >= lo) & (e <= hi)
        if kind == "like":
            import re as _re

            pat_ast = ast[2]
            if pat_ast[0] != "lit" or not isinstance(pat_ast[1], str):
                raise ValueError("LIKE pattern must be a string literal")
            # SQL wildcards: % -> .*, _ -> . (everything else literal)
            rx = _re.compile(
                "^"
                + "".join(
                    ".*" if ch == "%" else "." if ch == "_" else _re.escape(ch)
                    for ch in pat_ast[1]
                )
                + "$"
            )
            from pathway_tpu_torch.internals import dtype as dt
            from pathway_tpu_torch.internals.expression import apply_with_type

            # NULL LIKE p is NULL (so NOT LIKE excludes NULL rows too);
            # declared Optional(BOOL) to match
            return apply_with_type(
                lambda s, rx=rx: None if s is None else rx.match(s) is not None,
                dt.Optional(dt.BOOL),
                _wrap(self.to_expr(ast[1], scope)),
            )
        if kind == "isnull":
            e = _wrap(self.to_expr(ast[1], scope))
            return e.is_not_none() if ast[2] else e.is_none()
        if kind == "case":
            from pathway_tpu_torch.internals.expression import if_else

            out = self.to_expr(ast[2], scope)  # ELSE (default NULL)
            for cond_ast, then_ast in reversed(ast[1]):
                out = if_else(
                    _wrap(self.to_expr(cond_ast, scope)),
                    _wrap(self.to_expr(then_ast, scope)),
                    _wrap(out),
                )
            return out
        if kind == "call":
            name, args = ast[1], ast[2]
            if name in _AGGS:
                if name == "count":
                    return pw.reducers.count()
                red = {
                    "sum": pw.reducers.sum, "avg": pw.reducers.avg,
                    "min": pw.reducers.min, "max": pw.reducers.max,
                }[name]
                return red(self.to_expr(args[0], scope))
            raise ValueError(f"unsupported SQL function {name!r}")
        raise ValueError(f"cannot translate {ast!r}")

    def default_name(self, ast) -> str:
        if ast[0] == "col":
            return ast[2]
        if ast[0] == "call":
            return ast[1]
        return "expr"


def _distinct(table: Table) -> Table:
    """SELECT DISTINCT: one row per distinct value tuple."""
    cols = table._column_names
    return table.groupby(*[table[c] for c in cols]).reduce(
        *[table[c] for c in cols]
    )


def _positional_align(left: Table, right: Table) -> Table:
    """Rename ``right``'s columns to ``left``'s, positionally (set ops
    match columns by position, like the reference's SQLGlot translation)."""
    if len(right._column_names) != len(left._column_names):
        raise ValueError("set-operation arms must have the same column count")
    renames = {
        ln: right[rn]
        for ln, rn in zip(left._column_names, right._column_names)
    }
    return right.select(**renames)


def _setop(left: Table, right: Table, op: str) -> Table:
    """Value-based INTERSECT / EXCEPT with SQL set semantics.

    Implemented as a tagged concat + groupby over all columns rather than
    a join, so NULL cells compare equal (SQL set ops use IS NOT DISTINCT
    FROM semantics, unlike joins) and the result is deduplicated."""
    import pathway_tpu_torch as pw

    right = _positional_align(left, right)
    cols = left._column_names
    a = left.select(*[left[c] for c in cols], _pw_l=1, _pw_r=0)
    b = right.select(*[right[c] for c in cols], _pw_l=0, _pw_r=1)
    u = a.concat_reindex(b)
    g = u.groupby(*[u[c] for c in cols]).reduce(
        *[u[c] for c in cols],
        _pw_l=pw.reducers.sum(u["_pw_l"]),
        _pw_r=pw.reducers.sum(u["_pw_r"]),
    )
    if op == "intersect":
        kept = g.filter((g["_pw_l"] > 0) & (g["_pw_r"] > 0))
    else:  # except
        kept = g.filter((g["_pw_l"] > 0) & (g["_pw_r"] == 0))
    return kept.select(**{c: kept[c] for c in cols})


def _split_conjuncts(ast) -> list:
    if isinstance(ast, tuple) and ast[0] == "and":
        return _split_conjuncts(ast[1]) + _split_conjuncts(ast[2])
    return [ast]


def _contains_in_sub(ast) -> bool:
    if not isinstance(ast, tuple):
        return False
    if ast[0] == "in_sub":
        return True
    return any(
        _contains_in_sub(c) for c in ast[1:] if isinstance(c, (tuple, list))
    )


def _apply_in_subquery(
    tr: "_Translator", scope: Table, node: tuple, tables: dict[str, Table]
) -> Table:
    """WHERE x [NOT] IN (SELECT c FROM ...) as a semi/anti-join.

    The subquery is deduplicated first, so the semi-join never duplicates
    scope rows.  NULL handling: a NULL probe value never matches (IN drops
    it; NOT IN drops it too, per SQL three-valued logic); NULL values
    *inside* the subquery are treated as non-matching values — stricter
    standard semantics would make NOT IN empty whenever the subquery
    contains a NULL, which is almost never what a query means."""
    import pathway_tpu_torch as pw

    _tag, left_ast, sub_ast, negated = node
    sub = _translate_select(sub_ast, tables)
    if len(sub._column_names) != 1:
        raise ValueError("IN (SELECT ...) must select exactly one column")
    sc = sub._column_names[0]
    subd = _distinct(sub)
    marked = subd.select(_pw_in_val=subd[sc], _pw_m=1)
    lexpr = _wrap(tr.to_expr(left_ast, scope))
    cols = scope._column_names
    if negated:
        # NULL probes drop first (NULL NOT IN (...) is NULL in SQL);
        # the anti-join then keeps rows with no subquery match
        non_null = scope.filter(~lexpr.is_none())
        j = non_null.join_left(marked, lexpr == marked["_pw_in_val"])
        j2 = j.select(
            **{c: pw.left[c] for c in cols}, _pw_m=pw.right["_pw_m"]
        )
        kept = j2.filter(j2["_pw_m"].is_none())
    else:
        j = scope.join(marked, lexpr == marked["_pw_in_val"])
        kept = j.select(**{c: pw.left[c] for c in cols})
    return kept.select(**{c: kept[c] for c in cols})


def sql(query: str, **tables: Table) -> Table:
    """Run a SQL query against keyword-named tables::

        pw.sql("SELECT owner, SUM(pets) AS total FROM t GROUP BY owner", t=t)

    Supported: SELECT [DISTINCT] expressions/aliases/*, FROM (incl.
    derived-table subqueries), WITH ctes, INNER/LEFT/RIGHT/OUTER JOIN ON
    equality, WHERE (incl. ``[NOT] IN (SELECT ...)`` semi/anti-join
    conjuncts), GROUP BY, HAVING, UNION [ALL], INTERSECT, EXCEPT,
    IN / BETWEEN / LIKE / IS [NOT] NULL / CASE WHEN, and
    SUM/COUNT/AVG/MIN/MAX.
    

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... a | b
    ... 1 | 10
    ... 2 | 20
    ... ''')
    >>> res = pw.sql("SELECT a, b FROM tab WHERE b > 15", tab=t)
    >>> pw.debug.compute_and_print(res, include_id=False)
    a | b
    2 | 20
    """
    stmt = _Parser(_tokenize(query)).statement()
    env = dict(tables)
    for name, sub_ast in stmt["ctes"]:
        env[name] = _translate_select(sub_ast, env)
    result = _translate_set(stmt["select"], env)
    for op, all_, node in stmt["setops"]:
        other = _translate_set(node, env)
        if op == "union":
            result = result.concat_reindex(_positional_align(result, other))
            if not all_:
                result = _distinct(result)
        else:  # except
            result = _setop(result, other, "except")
    return result


def _translate_set(node: Any, tables: dict[str, Table]) -> Table:
    """An intersect-chain unit: a plain select dict or ("intersect", l, r)."""
    if isinstance(node, tuple) and node[0] == "intersect":
        return _setop(
            _translate_set(node[1], tables),
            _translate_set(node[2], tables),
            "intersect",
        )
    return _translate_select(node, tables)


def _translate_select(ast: dict, tables: dict[str, Table]) -> Table:
    tables = dict(tables)
    tr = _Translator(tables)
    if isinstance(ast["table"], tuple):  # ("subquery", sub_ast, alias)
        _tag, sub_ast, alias = ast["table"]
        base = _translate_select(sub_ast, tables)
        tables[alias] = base
        tr = _Translator(tables)
    else:
        base = tables.get(ast["table"])
    if base is None:
        raise KeyError(f"unknown table {ast['table']!r} (pass it as a kwarg)")

    scope = base
    for how, jt_name, cond in ast["joins"]:
        jt = tables.get(jt_name)
        if jt is None:
            raise KeyError(f"unknown table {jt_name!r}")
        if cond[0] != "cmp" or cond[1] != "=":
            raise ValueError("JOIN ON must be an equality")
        left_e = tr.to_expr(cond[2], scope)
        right_e = tr.to_expr(cond[3], scope)
        jr = {
            "inner": scope.join,
            "left": scope.join_left,
            "right": scope.join_right,
            "outer": scope.join_outer,
        }[how](jt, _wrap(left_e) == _wrap(right_e))
        import pathway_tpu_torch as pw

        seen: dict[str, Any] = {}
        for c in scope._column_names:
            seen[c] = pw.left[c]
        for c in jt._column_names:
            if c not in seen:
                seen[c] = pw.right[c]
        scope = jr.select(**seen)

    if ast["where"] is not None:
        # [NOT] IN (SELECT ...) conjuncts become semi/anti-joins; the
        # remaining conjuncts recombine into one ordinary filter
        plain: list = []
        for conj in _split_conjuncts(ast["where"]):
            if isinstance(conj, tuple) and conj[0] == "in_sub":
                scope = _apply_in_subquery(tr, scope, conj, tables)
            elif _contains_in_sub(conj):
                raise ValueError(
                    "IN (SELECT ...) is only supported as a top-level "
                    "WHERE conjunct"
                )
            else:
                plain.append(conj)
        if plain:
            combined = plain[0]
            for conj in plain[1:]:
                combined = ("and", combined, conj)
            scope = scope.filter(_wrap(tr.to_expr(combined, scope)))

    items = ast["items"]
    if ast["group_by"]:
        group_exprs = [tr.to_expr(g, scope) for g in ast["group_by"]]
        grouped = scope.groupby(*group_exprs)
        outs: dict[str, Any] = {}
        for e_ast, alias in items:
            if e_ast == ("star",):
                raise ValueError("SELECT * with GROUP BY is not supported")
            name = alias or tr.default_name(e_ast)
            outs[name] = tr.to_expr(e_ast, scope)
        having_ast = ast["having"]
        hidden: list[str] = []
        if having_ast is not None:
            # HAVING may re-state aggregates (HAVING SUM(x) > 2): hoist
            # them into hidden reduce columns and reference those
            def hoist(node):
                if isinstance(node, tuple) and node[0] == "call" and node[1] in _AGGS:
                    name = f"_pw_having_{len(hidden)}"
                    hidden.append(name)
                    outs[name] = tr.to_expr(node, scope)
                    return ("col", None, name)
                if isinstance(node, tuple):
                    return tuple(
                        hoist(c) if isinstance(c, tuple) else c for c in node
                    )
                return node

            having_ast = hoist(having_ast)
        result = grouped.reduce(**outs)
        if having_ast is not None:
            result = result.filter(_wrap(tr.to_expr(having_ast, result)))
            if hidden:
                keep = [c for c in result._column_names if c not in hidden]
                result = result.select(**{c: result[c] for c in keep})
        return _distinct(result) if ast["distinct"] else result

    if any(_has_agg(e) for e, _ in items):
        outs = {}
        for e_ast, alias in items:
            name = alias or tr.default_name(e_ast)
            outs[name] = tr.to_expr(e_ast, scope)
        return scope.reduce(**outs)

    if len(items) == 1 and items[0][0] == ("star",):
        return _distinct(scope) if ast["distinct"] else scope
    outs = {}
    for e_ast, alias in items:
        if e_ast == ("star",):
            for c in scope._column_names:
                outs[c] = scope[c]
            continue
        name = alias or tr.default_name(e_ast)
        outs[name] = tr.to_expr(e_ast, scope)
    result = scope.select(**outs)
    return _distinct(result) if ast["distinct"] else result
