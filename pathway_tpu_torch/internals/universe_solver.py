"""Universe solver — key-set relation registry (reference
``internals/universe_solver.py:1-178``: can two tables share keys?).

Universes here are structural layout tokens; the solver tracks the
DECLARED relations between them (``promise_is_subset_of`` etc.) and
answers reflexive-transitive subset queries.  ``with_universe_of``
consults it: rebinding a table whose universe has NO known relation to
the target logs a warning (the reference raises unless provable).

Storage is weak: tokens are plain sentinels owned by their tables, so
registered relations vanish with the tables — a long-lived process that
keeps building graphs does not accumulate entries.
"""

from __future__ import annotations

import weakref
from typing import Any

__all__ = ["UniverseSolver", "UniverseToken", "solver"]


class UniverseToken:
    """Weakref-able universe sentinel (plain ``object()`` instances do not
    support weak references)."""

    __slots__ = ("__weakref__",)


class UniverseSolver:
    def __init__(self) -> None:
        #: token -> set of tokens it is declared a subset of (direct edges)
        self._subset_of: "weakref.WeakKeyDictionary[Any, weakref.WeakSet]" = (
            weakref.WeakKeyDictionary()
        )
        #: equivalence: token -> representative
        self._equal: "weakref.WeakKeyDictionary[Any, Any]" = (
            weakref.WeakKeyDictionary()
        )

    # -- registration ---------------------------------------------------
    def register_as_subset(self, sub: Any, sup: Any) -> None:
        rep_sub = self._rep(sub)
        edges = self._subset_of.get(rep_sub)
        if edges is None:
            edges = weakref.WeakSet()
            self._subset_of[rep_sub] = edges
        edges.add(self._rep(sup))

    def register_as_equal(self, a: Any, b: Any) -> None:
        ra, rb = self._rep(a), self._rep(b)
        if ra is not rb:
            self._equal[rb] = ra
            edges = self._subset_of.pop(rb, None)
            if edges:
                target = self._subset_of.get(ra)
                if target is None:
                    target = weakref.WeakSet()
                    self._subset_of[ra] = target
                for e in edges:
                    target.add(e)

    # -- queries --------------------------------------------------------
    def _rep(self, token: Any) -> Any:
        seen = []
        while token in self._equal:
            seen.append(token)
            token = self._equal[token]
        for t in seen:  # path compression
            self._equal[t] = token
        return token

    def query_is_subset_of(self, sub: Any, sup: Any) -> bool:
        """Reflexive-transitive closure over declared subset edges."""
        sub, sup = self._rep(sub), self._rep(sup)
        if sub is sup:
            return True
        frontier = [sub]
        visited = {id(sub)}
        while frontier:
            t = frontier.pop()
            for nxt in tuple(self._subset_of.get(t, ())):
                nxt = self._rep(nxt)
                if nxt is sup:
                    return True
                if id(nxt) not in visited:
                    visited.add(id(nxt))
                    frontier.append(nxt)
        return False

    def query_are_equal(self, a: Any, b: Any) -> bool:
        return self._rep(a) is self._rep(b)

    def query_related(self, a: Any, b: Any) -> bool:
        """Any declared relation path between the two universes."""
        return (
            self.query_are_equal(a, b)
            or self.query_is_subset_of(a, b)
            or self.query_is_subset_of(b, a)
        )

    def clear(self) -> None:
        self._subset_of.clear()
        self._equal.clear()


#: process-global solver; weak storage means entries die with their tables
solver = UniverseSolver()
