"""``pw.universes`` — key-set relation promises (reference
``python/pathway/universes.py``).

In the reference these register facts with the universe solver; here
universes are structural (layout tokens), so promises adjust the
tables' tokens and are validated lazily at zip time.
"""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table

__all__ = [
    "promise_is_subset_of",
    "promise_are_equal",
    "promise_are_pairwise_disjoint",
]


def promise_is_subset_of(subset: Table, superset: Table) -> Table:
    """Declare subset's keys ⊆ superset's keys; returns ``subset`` bound to
    superset's universe (enables cross-table column use in select).  The
    relation is also registered with the universe solver (reference
    ``universe_solver.py``) so later operations can query it."""
    from pathway_tpu_torch.internals.universe_solver import solver

    solver.register_as_subset(subset._layout_token, superset._layout_token)
    out = subset.copy()
    out._layout_token = superset._layout_token
    return out


def promise_are_equal(*tables: Table) -> None:
    """Declare all tables share the same key set."""
    from pathway_tpu_torch.internals.universe_solver import solver

    if not tables:
        return
    token = tables[0]._layout_token
    for t in tables[1:]:
        solver.register_as_equal(token, t._layout_token)
        t._layout_token = token


def promise_are_pairwise_disjoint(*tables: Table) -> None:
    """Declare the tables' key sets are pairwise disjoint (concat is then
    safe; our concat already checks at runtime)."""
    return None
