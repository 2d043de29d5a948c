"""Stateful operators (reference ``python/pathway/stdlib/stateful/``)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table

__all__ = ["deduplicate"]


def deduplicate(
    table: Table,
    *,
    value: Any,
    instance: Any = None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
) -> Table:
    """Keep one accepted row per instance (reference
    ``stdlib/stateful/deduplicate.py:9`` → engine ``deduplicate``
    ``src/engine/graph.rs:895``)."""
    return table.deduplicate(value=value, instance=instance, acceptor=acceptor)
