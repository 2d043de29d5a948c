"""Metadata filter expressions for index queries (counterpart of
``pathway_tpu/stdlib/indexing/filters.py``).

The reference filters index matches with JMESPath expressions plus a
custom ``globmatch`` function (``src/external_integration/mod.rs:92-181``).
jmespath isn't available in this environment, so this is a small
evaluator for the subset those filters actually use:

- comparisons: ``==  !=  <  <=  >  >=`` (backtick, single- or
  double-quoted literals; bare numbers);
- boolean: ``&&  ||  !``, parentheses;
- dotted field paths into the metadata dict (``owner.name``);
- functions: ``contains(haystack, needle)``,
  ``globmatch('pattern', field)``.

``compile_filter(expr)`` returns ``metadata_dict -> bool``.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable

__all__ = ["compile_filter"]

_TOKEN = re.compile(
    r"\s*(?:(?P<op>==|!=|<=|>=|&&|\|\||[!<>()=,])"
    r"|(?P<backtick>`[^`]*`)"
    r"|(?P<string>'[^']*'|\"[^\"]*\")"
    r"|(?P<number>-?\d+(?:\.\d+)?)"
    r"|(?P<name>[A-Za-z_][\w.]*))"
)


def _tokenize(src: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise ValueError(f"bad filter syntax at: {src[pos:]!r}")
        pos = m.end()
        for kind in ("op", "backtick", "string", "number", "name"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    out.append(("end", ""))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def eat(self, kind: str | None = None, value: str | None = None) -> tuple[str, str]:
        k, v = self.toks[self.i]
        if (kind and k != kind) or (value and v != value):
            raise ValueError(f"unexpected token {v!r} (wanted {value or kind})")
        self.i += 1
        return k, v

    # expr := or_expr
    def parse(self) -> Callable[[dict], Any]:
        e = self._or()
        self.eat("end")
        return e

    def _or(self):
        left = self._and()
        while self.peek() == ("op", "||"):
            self.eat()
            right = self._and()
            left = (lambda l, r: lambda m: bool(l(m)) or bool(r(m)))(left, right)
        return left

    def _and(self):
        left = self._not()
        while self.peek() == ("op", "&&"):
            self.eat()
            right = self._not()
            left = (lambda l, r: lambda m: bool(l(m)) and bool(r(m)))(left, right)
        return left

    def _not(self):
        if self.peek() == ("op", "!"):
            self.eat()
            inner = self._not()
            return lambda m: not bool(inner(m))
        return self._cmp()

    _CMPS: dict[str, Callable[[Any, Any], bool]] = {
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
        "<": lambda a, b: a is not None and b is not None and a < b,
        "<=": lambda a, b: a is not None and b is not None and a <= b,
        ">": lambda a, b: a is not None and b is not None and a > b,
        ">=": lambda a, b: a is not None and b is not None and a >= b,
    }

    def _cmp(self):
        left = self._atom()
        k, v = self.peek()
        if k == "op" and v in self._CMPS:
            self.eat()
            right = self._atom()
            op = self._CMPS[v]
            return (lambda l, r, op: lambda m: op(l(m), r(m)))(left, right, op)
        return left

    def _atom(self):
        k, v = self.peek()
        if k == "op" and v == "(":
            self.eat()
            e = self._or()
            self.eat("op", ")")
            return e
        if k == "backtick":
            self.eat()
            lit = _parse_literal(v[1:-1])
            return lambda m: lit
        if k == "string":
            self.eat()
            s = v[1:-1]
            return lambda m: s
        if k == "number":
            self.eat()
            n = float(v) if "." in v else int(v)
            return lambda m: n
        if k == "name":
            self.eat()
            if self.peek() == ("op", "("):
                return self._call(v)
            path = v.split(".")

            def lookup(m: dict, path=path):
                cur: Any = m
                for p in path:
                    if not isinstance(cur, dict):
                        return None
                    cur = cur.get(p)
                return cur

            return lookup
        raise ValueError(f"unexpected token {v!r}")

    def _call(self, fname: str):
        self.eat("op", "(")
        args = [self._or()]
        while self.peek() == ("op", ","):
            self.eat()
            args.append(self._or())
        self.eat("op", ")")
        if fname == "contains":
            a, b = args
            return lambda m: (lambda h, n: n in h if h is not None else False)(a(m), b(m))
        if fname == "globmatch":
            pat, field = args
            return lambda m: (
                lambda p, f: fnmatch.fnmatch(str(f), str(p))
                if f is not None and p is not None
                else False
            )(pat(m), field(m))
        raise ValueError(f"unknown filter function {fname!r}")


def _parse_literal(raw: str) -> Any:
    raw = raw.strip()
    if raw in ("true", "false"):
        return raw == "true"
    if raw == "null":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if len(raw) >= 2 and raw[0] in "'\"" and raw[-1] == raw[0]:
        return raw[1:-1]
    return raw


_COMPILE_CACHE: dict[str, Callable[[dict], bool]] = {}
_COMPILE_CACHE_MAX = 1024


def compile_filter(expr: str) -> Callable[[dict], bool]:
    """Compile a filter expression into ``metadata -> bool``; metadata is
    the per-document dict captured by the index.  Compilations are memoized
    (filters are usually a handful of constant strings re-used per query)."""
    cached = _COMPILE_CACHE.get(expr)
    if cached is not None:
        return cached
    fn = _Parser(_tokenize(expr)).parse()

    def run(meta: dict | None) -> bool:
        try:
            return bool(fn(meta or {}))
        except Exception:
            return False

    if len(_COMPILE_CACHE) < _COMPILE_CACHE_MAX:
        _COMPILE_CACHE[expr] = run
    return run
