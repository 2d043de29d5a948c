"""``DataIndex`` — the retrieval entry point over engine external indexes
(counterpart of ``pathway_tpu/stdlib/indexing/data_index.py``).

Capability parity with reference ``stdlib/indexing/data_index.py:206-473``
(``DataIndex`` with ``query`` / ``query_as_of_now``) and
``nearest_neighbors.py`` / ``bm25.py`` / ``hybrid_index.py`` factories.
The KNN inner index is the card-resident slab
(:class:`pathway_tpu_torch.parallel.ShardedKnnIndex`); every epoch's queries
are answered with one fused score + top-k launch (K3).  The KNN inner
indexes and their factories take ``device=`` (default ``"cuda"``; a
factory resolves it when it is made, so it raises on a machine with no
card unless the caller asks for ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine.external_index import ExternalIndexNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference, _wrap
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.engine import graph as eg
from pathway_tpu_torch.stdlib.indexing.adapters import BM25Adapter, HybridAdapter, KnnAdapter

__all__ = [
    "InnerIndex",
    "BruteForceKnn",
    "UsearchKnn",
    "LshKnn",
    "TantivyBM25",
    "HybridIndex",
    "InnerIndexFactory",
    "BruteForceKnnFactory",
    "UsearchKnnFactory",
    "LshKnnFactory",
    "TantivyBM25Factory",
    "HybridIndexFactory",
    "BruteForceKnnMetricKind",
    "DataIndex",
]


class BruteForceKnnMetricKind:
    COS = "cos"
    L2SQ = "l2sq"
    DOT = "dot"


# ---------------------------------------------------------------------------
# Inner indexes


class InnerIndex:
    """Binds index-side columns; subclasses build the host adapter."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
    ):
        self.data_column = data_column
        self.metadata_column = metadata_column
        self.data_table: Table = data_column._table
        self.embedder: Any = None  # optional UDF str -> vector

    def make_adapter(self) -> Any:
        raise NotImplementedError

    def query_payload_expr(self, query_column: ColumnExpression) -> ColumnExpression:
        return query_column


class BruteForceKnn(InnerIndex):
    """Exact KNN on the card-resident slab (reference
    ``nearest_neighbors.py:65`` over the Rust brute-force engine index)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        metric: str = BruteForceKnnMetricKind.COS,
        mesh: Any = None,
        dtype: Any = None,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(data_column, metadata_column)
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric
        self.mesh = mesh
        self.dtype = dtype
        self.device = device
        # live-maintenance knobs for the segment layer fronting the
        # index (delta segment + background merge; PATHWAY_INDEX_* env
        # defaults apply when unset)
        self.delta_cap = delta_cap
        self.tombstone_fraction = tombstone_fraction
        self.auto_merge = auto_merge

    def _maintenance_kwargs(self) -> dict:
        return {
            "delta_cap": self.delta_cap,
            "tombstone_fraction": self.tombstone_fraction,
            "auto_merge": self.auto_merge,
        }

    def make_adapter(self) -> Any:
        return KnnAdapter(
            self.dimensions,
            metric=self.metric,
            capacity=self.reserved_space,
            mesh=self.mesh,
            dtype=self.dtype,
            device=self.device,
            **self._maintenance_kwargs(),
        )


class UsearchKnn(BruteForceKnn):
    """Approximate KNN (reference ``USearchKnn`` fronting an HNSW,
    ``src/external_integration/usearch_integration.rs``).  Backed by the
    native host HNSW graph (the port's ``native/pathway_native.cpp``
    ``hnsw_*`` via
    :class:`~pathway_tpu_torch.stdlib.indexing.hnsw.HnswIndex`) — the graph
    walk is pointer-chasing, so like the reference it runs on the host,
    not on the card.  Pass ``nlist``/``nprobe`` to choose the card-resident
    IVF-flat alternative instead (:class:`pathway_tpu_torch.parallel.IvfKnnIndex`:
    k-means cells in device memory, the centroid assignment K11 and the
    cell scan K12), which trades a little recall for device-side batch
    throughput."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        metric: str = BruteForceKnnMetricKind.COS,
        mesh: Any = None,
        dtype: Any = None,
        nlist: int | None = None,
        nprobe: int | None = None,
        M: int = 16,
        ef_construction: int = 128,
        ef_search: int = 64,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            mesh=mesh,
            dtype=dtype,
            delta_cap=delta_cap,
            tombstone_fraction=tombstone_fraction,
            auto_merge=auto_merge,
            device=device,
        )
        self.nlist = nlist
        self.nprobe = nprobe
        self.M = M
        self.ef_construction = ef_construction
        self.ef_search = ef_search

    def make_adapter(self) -> Any:
        if self.mesh is not None:
            # HNSW/IVF are single-host; a mesh caller sized reserved_space
            # for the aggregate device memory of all cards — give them the SHARDED
            # exact index rather than silently dropping the mesh
            import logging

            logging.getLogger("pathway_tpu_torch").info(
                "UsearchKnn: mesh given -> using the mesh-sharded exact "
                "brute-force index (graph/IVF ANN is single-host)"
            )
            return super().make_adapter()
        if self.nlist is not None or self.nprobe is not None:
            if self.metric == BruteForceKnnMetricKind.L2SQ:
                return super().make_adapter()  # IVF cells are ip-trained
            from pathway_tpu_torch.stdlib.indexing.adapters import IvfAdapter

            return IvfAdapter(
                self.dimensions,
                metric=self.metric,
                capacity=self.reserved_space,
                dtype=self.dtype,
                nlist=self.nlist,
                nprobe=self.nprobe,
                device=self.device,
                **self._maintenance_kwargs(),
            )
        from pathway_tpu_torch.stdlib.indexing.adapters import HnswAdapter

        return HnswAdapter(
            self.dimensions,
            metric=self.metric,
            M=self.M,
            ef_construction=self.ef_construction,
            ef_search=self.ef_search,
            **self._maintenance_kwargs(),
        )


class LshKnn(BruteForceKnn):
    """LSH-bucketed KNN API surface (reference ``LshKnn``,
    ``nearest_neighbors.py:414``).  Exact K3 search under the hood (see
    :class:`UsearchKnn` note); ``stdlib.ml`` keeps a true LSH classifier."""


class TantivyBM25(InnerIndex):
    """Full-text BM25 (reference ``bm25.py:41-135``; host inverted index
    standing in for tantivy)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        ram_budget: int = 50_000_000,
        in_memory_index: bool = True,
    ):
        super().__init__(data_column, metadata_column)

    def make_adapter(self) -> Any:
        return BM25Adapter()


class HybridIndex(InnerIndex):
    """Reciprocal-rank fusion of several inner indexes (reference
    ``hybrid_index.py:14-147``)."""

    def __init__(self, inner_indexes: Sequence[InnerIndex], *, k: float = 60.0):
        assert inner_indexes, "HybridIndex needs at least one inner index"
        first = inner_indexes[0]
        super().__init__(first.data_column, first.metadata_column)
        self.children = list(inner_indexes)
        self.rrf_k = k

    def make_adapter(self) -> Any:
        return HybridAdapter([c.make_adapter() for c in self.children], self.rrf_k)


# ---------------------------------------------------------------------------
# Factories (reference ``InnerIndexFactory`` family)


class InnerIndexFactory:
    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnReference | None = None,
    ) -> InnerIndex:
        raise NotImplementedError

    def build_data_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnReference | None = None,
    ) -> "DataIndex":
        return DataIndex(
            data_table, self.build_index(data_column, data_table, metadata_column)
        )


@dataclasses.dataclass
class BruteForceKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    metric: str = BruteForceKnnMetricKind.COS
    embedder: Any = None
    mesh: Any = None
    delta_cap: int | None = None
    tombstone_fraction: float | None = None
    auto_merge: bool | None = None
    device: Any = "cuda"

    _cls = BruteForceKnn

    def __post_init__(self) -> None:
        # the index is made when a query is built; a machine with no card
        # learns it here, where the factory is made, not at that query
        if self.mesh is None:
            resolve_device(self.device)

    def build_index(self, data_column, data_table, metadata_column=None) -> InnerIndex:
        dims = self.dimensions
        if dims is None:
            if self.embedder is None:
                raise ValueError("dimensions required when no embedder is given")
            dims = _embedder_dimension(self.embedder)
        idx = self._cls(
            data_column,
            metadata_column,
            dimensions=dims,
            reserved_space=self.reserved_space,
            metric=self.metric,
            mesh=self.mesh,
            delta_cap=self.delta_cap,
            tombstone_fraction=self.tombstone_fraction,
            auto_merge=self.auto_merge,
            device=self.device,
            **self._index_kwargs(),
        )
        idx.embedder = self.embedder
        return idx

    def _index_kwargs(self) -> dict:
        return {}


@dataclasses.dataclass
class UsearchKnnFactory(BruteForceKnnFactory):
    """Factory of :class:`UsearchKnn`.  Beyond the JAX package's factory
    it takes the inner index's ``nlist``/``nprobe``: given, the IVF on the
    card; otherwise the host HNSW."""

    nlist: int | None = None
    nprobe: int | None = None

    _cls = UsearchKnn

    def _index_kwargs(self) -> dict:
        return {"nlist": self.nlist, "nprobe": self.nprobe}


class LshKnnFactory(BruteForceKnnFactory):
    _cls = LshKnn


@dataclasses.dataclass
class TantivyBM25Factory(InnerIndexFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_index(self, data_column, data_table, metadata_column=None) -> InnerIndex:
        return TantivyBM25(data_column, metadata_column)


@dataclasses.dataclass
class HybridIndexFactory(InnerIndexFactory):
    retriever_factories: list[InnerIndexFactory] = dataclasses.field(default_factory=list)
    k: float = 60.0

    def build_index(self, data_column, data_table, metadata_column=None) -> InnerIndex:
        children = [
            f.build_index(data_column, data_table, metadata_column)
            for f in self.retriever_factories
        ]
        idx = HybridIndex(children, k=self.k)
        return idx


def _embedder_dimension(embedder: Any) -> int:
    """Probe an embedder UDF for its output width."""
    import inspect

    import numpy as np

    if hasattr(embedder, "get_embedding_dimension"):
        return int(embedder.get_embedding_dimension())
    batch = getattr(embedder, "__batch__", None)
    if batch is not None:
        # epoch-batch contract: one LIST in, aligned list out
        probe = batch(["probe"])[0]
    elif hasattr(embedder, "__wrapped__"):
        probe = embedder.__wrapped__("probe")
    else:
        probe = embedder("probe")
    if inspect.isawaitable(probe):
        import asyncio

        probe = asyncio.run(probe)
    return int(np.asarray(probe).reshape(-1).shape[0])


# ---------------------------------------------------------------------------
# DataIndex

REPLY_ID = "_pw_index_reply_id"
REPLY_SCORE = "_pw_index_reply_score"
REPLY_DATA = "_pw_index_reply"


class DataIndex:
    """Queryable live index over ``data_table``.

    ``query_as_of_now`` answers each query once, against the index state
    at its arrival epoch (reference as-of-now semantics);
    ``query`` keeps answers consistent as the corpus changes.
    """

    def __init__(self, data_table: Table, inner_index: InnerIndex):
        self.data_table = data_table
        self.inner = inner_index

    # -- index side -----------------------------------------------------
    def _index_side(self) -> tuple[eg.Node, Callable, Callable, Callable]:
        orig_table = self.inner.data_table
        table = orig_table
        data_expr = self.inner.data_column
        if self.inner.embedder is not None and _is_str(table, data_expr):
            table = table.with_columns(_pw_index_payload=self.inner.embedder(data_expr))
            payload_ref: ColumnExpression = table["_pw_index_payload"]
        else:
            payload_ref = data_expr
        # HybridIndex: payload is a tuple with one element per child index,
        # each passed through that child's own embedder when it has one
        if isinstance(self.inner, HybridIndex):
            for ci, child in enumerate(self.inner.children):
                if child.embedder is not None and _is_str(orig_table, child.data_column):
                    expr = _retable(child.data_column, orig_table, table)
                    table = table.with_columns(
                        **{f"_pw_index_payload_{ci}": child.embedder(expr)}
                    )
            layout = table._layout()
            child_fns = []
            for ci, child in enumerate(self.inner.children):
                if f"_pw_index_payload_{ci}" in table._column_names:
                    expr: Any = table[f"_pw_index_payload_{ci}"]
                else:
                    expr = _retable(child.data_column, orig_table, table)
                child_fns.append(_wrap(expr)._compile(layout.resolver))
            payload_fn = lambda key, values, fns=child_fns: tuple(  # noqa: E731
                f((key, values)) for f in fns
            )
        else:
            layout = table._layout()
            c = _wrap(payload_ref)._compile(layout.resolver)
            payload_fn = lambda key, values: c((key, values))  # noqa: E731
        cols = orig_table._column_names
        n = len(cols)

        def data_fn(key, values):
            return dict(zip(cols, values[:n]))

        if self.inner.metadata_column is not None:
            meta_expr = _retable(self.inner.metadata_column, orig_table, table)
            mc = _wrap(meta_expr)._compile(layout.resolver)

            def meta_fn(key, values):
                m = mc((key, values))
                if hasattr(m, "as_dict"):
                    m = m.as_dict()
                return m if isinstance(m, dict) else None

        else:
            meta_fn = lambda key, values: None  # noqa: E731
        return table._node, payload_fn, data_fn, meta_fn

    # -- query side -----------------------------------------------------
    def _build(
        self,
        query_column: ColumnExpression,
        number_of_matches: Any,
        metadata_filter: Any,
        as_of_now: bool,
    ) -> Table:
        qref = query_column
        query_table: Table = (
            qref._table if isinstance(qref, ColumnReference) else None
        )
        if query_table is None:
            refs = _wrap(qref)._references()
            tables = {r._table for r in refs}
            assert len(tables) == 1, "query expression must reference one table"
            query_table = tables.pop()
        orig_query_table = query_table
        if self.inner.embedder is not None and _is_str(query_table, qref):
            query_table = query_table.with_columns(
                _pw_query_payload=self.inner.embedder(qref)
            )
            # with_columns preserves parent column names/positions, so
            # re-anchor sibling expressions (k, filter) onto the new table
            number_of_matches = _retable(
                number_of_matches, orig_query_table, query_table
            )
            metadata_filter = _retable(metadata_filter, orig_query_table, query_table)
            payload_expr: ColumnExpression = query_table["_pw_query_payload"]
        else:
            payload_expr = qref
        if isinstance(self.inner, HybridIndex):
            # per-child query payloads, each through that child's embedder
            base_expr = payload_expr
            child_exprs: list[Any] = []
            hybrid_base = query_table
            for ci, child in enumerate(self.inner.children):
                if child.embedder is not None and _is_str(orig_query_table, qref):
                    e = _retable(base_expr, orig_query_table, query_table)
                    query_table = query_table.with_columns(
                        **{f"_pw_query_payload_{ci}": child.embedder(e)}
                    )
                    child_exprs.append(f"_pw_query_payload_{ci}")
                else:
                    child_exprs.append(None)
            if query_table is not hybrid_base:
                number_of_matches = _retable(
                    number_of_matches, orig_query_table, query_table
                )
                metadata_filter = _retable(
                    metadata_filter, orig_query_table, query_table
                )
            layout = query_table._layout()
            child_fns = []
            for ci, name in enumerate(child_exprs):
                if name is not None:
                    expr: Any = query_table[name]
                else:
                    expr = _retable(base_expr, orig_query_table, query_table)
                child_fns.append(_wrap(expr)._compile(layout.resolver))
            q_payload_fn = lambda key, values, fns=child_fns: tuple(  # noqa: E731
                f((key, values)) for f in fns
            )
        else:
            layout = query_table._layout()
            pc = _wrap(payload_expr)._compile(layout.resolver)
            q_payload_fn = lambda key, values: pc((key, values))  # noqa: E731

        if isinstance(number_of_matches, ColumnExpression):
            kc = _wrap(query_table._subst(number_of_matches))._compile(layout.resolver)
            k_fn = lambda key, values: kc((key, values))  # noqa: E731
        else:
            k_const = int(number_of_matches)
            k_fn = lambda key, values: k_const  # noqa: E731

        if metadata_filter is None:
            f_fn = None
        elif isinstance(metadata_filter, ColumnExpression):
            fc = _wrap(query_table._subst(metadata_filter))._compile(layout.resolver)
            f_fn = lambda key, values: fc((key, values))  # noqa: E731
        else:
            f_fn = lambda key, values: metadata_filter  # noqa: E731

        index_node, payload_fn, data_fn, meta_fn = self._index_side()
        node = ExternalIndexNode(
            G.engine_graph,
            index_node,
            query_table._node,
            self.inner.make_adapter(),
            index_payload_fn=payload_fn,
            index_data_fn=data_fn,
            index_meta_fn=meta_fn,
            query_payload_fn=q_payload_fn,
            query_k_fn=k_fn,
            query_filter_fn=f_fn,
            as_of_now=as_of_now,
        )
        # the index side is a keyed upsert stream into adapter state:
        # applying same-key updates out of order serves stale vectors
        # (distribution pass treats input 0 as order-sensitive, PW-X001)
        node.meta["index"] = {
            "upsert": True,
            "order_sensitive": True,
            "adapter": type(self.inner).__name__,
        }
        cols = query_table._column_names + [REPLY_ID, REPLY_SCORE, REPLY_DATA]
        dtypes = dict(query_table._dtypes)
        dtypes[REPLY_ID] = dt.ANY
        dtypes[REPLY_SCORE] = dt.ANY
        dtypes[REPLY_DATA] = dt.ANY
        result = Table(
            node,
            cols,
            dtypes,
            name="index_reply",
            layout_token=query_table._layout_token,
        )
        if any(c.startswith("_pw_query_payload") for c in result._column_names):
            keep = [c for c in cols if not c.startswith("_pw_query_payload")]
            result = result.select(**{c: result[c] for c in keep})
        return result

    def query_as_of_now(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: Any = None,
    ) -> Table:
        out = self._build(query_column, number_of_matches, metadata_filter, True)
        return out if collapse_rows else _flatten_replies(out)

    def query(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: Any = None,
    ) -> Table:
        out = self._build(query_column, number_of_matches, metadata_filter, False)
        return out if collapse_rows else _flatten_replies(out)


def _retable(expr: Any, old: Table, new: Table) -> Any:
    """Rebuild ``expr`` with references to ``old`` re-anchored on ``new``
    (valid when ``new`` preserves ``old``'s column names, e.g. the result
    of ``with_columns``)."""
    if not isinstance(expr, ColumnExpression):
        return expr
    if isinstance(expr, ColumnReference):
        if expr._table is old and expr._name in new._column_names:
            return ColumnReference(new, expr._name)
        return expr
    children = list(expr._children())
    if not children:
        return expr
    return expr._rebuild([_retable(c, old, new) for c in children])


def _is_str(table: Table, expr: ColumnExpression) -> bool:
    if isinstance(expr, ColumnReference) and expr._name in table._dtypes:
        d = table._dtypes[expr._name].strip_optional()
        return d in (dt.STR, dt.ANY)
    return True  # unknown expression: assume text when an embedder exists


def _flatten_replies(result: Table) -> Table:
    """One row per match: reply tuples zipped + flattened + unpacked."""
    zipped = result.select(
        *[result[c] for c in result._column_names if not c.startswith("_pw_index_reply")],
        _pw_reply_zip=_zip3(result[REPLY_ID], result[REPLY_SCORE], result[REPLY_DATA]),
    )
    flat = zipped.flatten(zipped["_pw_reply_zip"])
    base = [c for c in flat._column_names if c != "_pw_reply_zip"]
    from pathway_tpu_torch.internals.expression import apply as pw_apply

    return flat.select(
        *[flat[c] for c in base],
        **{
            REPLY_ID: pw_apply(lambda z: z[0], flat["_pw_reply_zip"]),
            REPLY_SCORE: pw_apply(lambda z: z[1], flat["_pw_reply_zip"]),
            REPLY_DATA: pw_apply(lambda z: z[2], flat["_pw_reply_zip"]),
        },
    )


def _zip3(a: Any, b: Any, c: Any) -> ColumnExpression:
    from pathway_tpu_torch.internals.expression import apply as pw_apply

    return pw_apply(
        lambda x, y, z: tuple(zip(x or (), y or (), z or ())), a, b, c
    )
