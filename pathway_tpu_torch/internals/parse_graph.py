"""Global graph holder ``G``.

Reference: ``python/pathway/internals/parse_graph.py`` keeps a global
``ParseGraph`` rebuilt per test.  Here the user API constructs engine nodes
eagerly (no separate replay layer is needed because nodes are stateless
descriptions — execution state lives in a per-run ``RunContext``), so ``G``
holds the single :class:`EngineGraph` plus the error log and run bookkeeping.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

from pathway_tpu_torch.engine.graph import EngineGraph

logger = logging.getLogger("pathway_tpu_torch")


class ParseGraph:
    def __init__(self) -> None:
        self.engine_graph = EngineGraph()
        self.errors: list[str] = []
        self.last_run_ctx: Any = None
        self._cache: dict[Any, Any] = {}
        #: lazily created global error-log table (pw.global_error_log)
        self.error_log_table: Any = None

    def clear(self) -> None:
        self.__init__()

    def log_error(self, message: str, trace: str = "") -> None:
        self.errors.append(message)
        logger.warning(
            "pathway_tpu_torch error value produced: %s%s",
            message,
            f" [at {trace}]" if trace else "",
        )
        # runtime (per-cell) errors also feed the global error-log table
        # of the run that produced them
        from pathway_tpu_torch.engine.graph import ErrorEntry, current_ctx

        ctx = current_ctx()
        if ctx is not None:
            entry = ErrorEntry(message, trace=trace, time=ctx.time)
            ctx.error_log.append(entry)
            if ctx.error_sink_enabled:
                ctx.error_pending.append(entry)


G = ParseGraph()


def global_error_log() -> Any:
    """The queryable global error-log Table (reference
    ``pw.global_error_log``, ``internals/parse_graph.py:183-202``): rows
    ``(message, operator, trace)`` — ``trace`` is the user file:line that
    created the failing operator.  Compose it like any table (filter,
    output, subscribe)."""
    if G.error_log_table is None:
        from pathway_tpu_torch.engine import graph as eg
        from pathway_tpu_torch.internals import dtype as dt
        from pathway_tpu_torch.internals.table import Table

        node = eg.ErrorLogNode(G.engine_graph)
        G.error_log_table = Table(
            node,
            ["message", "operator", "trace"],
            {"message": dt.STR, "operator": dt.STR, "trace": dt.STR},
            name="global_error_log",
        )
    return G.error_log_table
