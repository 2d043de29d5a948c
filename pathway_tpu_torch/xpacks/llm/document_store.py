"""DocumentStore: live parse -> post-process -> split -> index pipeline
(reference ``xpacks/llm/document_store.py:233-471``; counterpart of
``pathway_tpu/xpacks/llm/document_store.py``).

Input tables come from connectors with columns ``data`` (bytes|str) and
optionally ``_metadata`` (dict).  The store builds the chunk table, feeds
the retriever's :class:`~pathway_tpu_torch.stdlib.indexing.DataIndex`
(the card-resident KNN slab / BM25 / hybrid), and answers retrieve / statistics / inputs
queries with as-of-now consistency.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndexFactory

__all__ = ["DocumentStore", "SlidesDocumentStore"]


def _merge_filters(metadata_filter: str | None, globpattern: str | None):
    """Combine a metadata filter with a path glob (reference
    ``merge_filters``, ``document_store.py:356``).  Returns a CALLABLE
    (metadata -> bool) so glob patterns never pass through string
    interpolation (no quoting/injection issues); a malformed filter
    fails CLOSED (rejects everything) rather than disabling filtering."""
    import fnmatch

    if not metadata_filter and not globpattern:
        return None
    meta_fn = None
    if metadata_filter:
        from pathway_tpu_torch.stdlib.indexing.filters import compile_filter

        try:
            meta_fn = compile_filter(metadata_filter)
        except Exception:
            return lambda m: False  # fail closed on malformed filters

    def run(meta: dict | None) -> bool:
        m = meta or {}
        if meta_fn is not None and not meta_fn(m):
            return False
        if globpattern and not fnmatch.fnmatch(str(m.get("path", "")), globpattern):
            return False
        return True

    return run


class DocumentStore:
    """reference ``document_store.py:233``"""

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: InnerIndexFactory,
        parser: UDF | Callable | None = None,
        splitter: UDF | Callable | None = None,
        doc_post_processors: list[Callable] | None = None,
    ):
        from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
        from pathway_tpu_torch.xpacks.llm.splitters import null_splitter

        self.docs = list(docs) if not isinstance(docs, Table) else [docs]
        self.retriever_factory = retriever_factory
        self.parser = parser if parser is not None else ParseUtf8()
        self.splitter = splitter if splitter is not None else null_splitter
        self.doc_post_processors = doc_post_processors or []
        self._index: DataIndex | None = None
        self._input_table: Table | None = None
        self._chunks: Table | None = None
        self.build_pipeline()

    # ------------------------------------------------------------------
    @staticmethod
    def _as_transformer_expr(fn: Any, *args: Any) -> Any:
        """UDFs are called directly (batched when they define __batch__);
        bare callables go through pw.apply."""
        if isinstance(fn, UDF):
            return fn(*args)
        return pw.apply(fn, *args)

    def build_pipeline(self) -> None:
        """reference ``document_store.py:286``"""
        tables = []
        for t in self.docs:
            cols: dict[str, Any] = {"data": t.data}
            if "_metadata" in t.column_names():
                cols["_metadata"] = t["_metadata"]
            else:
                cols["_metadata"] = pw.apply(lambda d: {}, t.data)
            tables.append(t.select(**cols))
        input_table = tables[0] if len(tables) == 1 else tables[0].concat_reindex(*tables[1:])
        self._input_table = input_table

        parsed = input_table.with_columns(
            _parsed=self._as_transformer_expr(self.parser, input_table.data)
        )
        # one row per parsed (text, meta) unit
        parsed_flat = parsed.flatten(parsed["_parsed"]).select(
            text=pw.apply(lambda p: p[0], pw.this["_parsed"]),
            _metadata=pw.apply(
                lambda p, m: {**(m or {}), **(p[1] or {})},
                pw.this["_parsed"],
                pw.this["_metadata"],
            ),
        )
        for post in self.doc_post_processors:
            parsed_flat = parsed_flat.select(
                text=pw.apply(lambda t, m, post=post: post(t, m)[0], pw.this.text, pw.this["_metadata"]),
                _metadata=pw.apply(lambda t, m, post=post: post(t, m)[1], pw.this.text, pw.this["_metadata"]),
            )
        chunked = parsed_flat.with_columns(
            _chunks=self._as_transformer_expr(self.splitter, parsed_flat.text)
        )
        chunks = chunked.flatten(chunked["_chunks"]).select(
            text=pw.apply(lambda c: c[0], pw.this["_chunks"]),
            metadata=pw.apply(
                lambda c, m: {**(m or {}), **(c[1] or {})},
                pw.this["_chunks"],
                pw.this["_metadata"],
            ),
        )
        self._chunks = chunks
        self._index = self.retriever_factory.build_data_index(
            chunks.text, chunks, metadata_column=chunks.metadata
        )

    @property
    def index(self) -> DataIndex:
        assert self._index is not None
        return self._index

    @property
    def input_table(self) -> Table:
        assert self._input_table is not None
        return self._input_table

    # ------------------------------------------------------------------
    # query surfaces (reference document_store.py:323-470)

    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)
        # multi-tenant serving: names the tenant for admission control /
        # SLO-class scheduling; absent → "default" tenant
        tenant: str | None = pw.column_definition(default_value=None)

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(pw.Schema):
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    def retrieve_query(self, queries: Table) -> Table:
        """reference ``document_store.py:426`` — returns a ``result`` column
        holding the matched docs as dicts sorted best-first."""
        merged = queries.with_columns(
            _pw_filter=pw.apply(
                _merge_filters, queries.metadata_filter, queries.filepath_globpattern
            )
        )
        replies = self.index.query_as_of_now(
            merged.query,
            number_of_matches=merged.k,
            metadata_filter=merged["_pw_filter"],
        )

        def to_docs(ids, scores, datas):
            out = []
            for _id, score, data in zip(ids or (), scores or (), datas or ()):
                d = dict(data or {})
                doc = {
                    "text": d.get("text", ""),
                    "metadata": d.get("metadata", {}),
                    "score": float(score),
                    "dist": -float(score),
                }
                out.append(doc)
            return out

        return replies.select(
            *[replies[c] for c in queries.column_names() if c in replies.column_names()],
            result=pw.apply(
                to_docs,
                replies["_pw_index_reply_id"],
                replies["_pw_index_reply_score"],
                replies["_pw_index_reply"],
            ),
        )

    def statistics_query(self, queries: Table) -> Table:
        """reference ``document_store.py:323`` — indexed file statistics."""
        stats = self.input_table.reduce(
            count=pw.reducers.count(),
            last_modified=pw.reducers.max(
                pw.apply(
                    lambda m: (m or {}).get("modified_at", 0), pw.this["_metadata"]
                )
            ),
        )
        # cross join (no on-conditions): every query row gets the one stats row
        return queries.join_left(stats, id=queries.id).select(
            result=pw.apply(
                lambda c, lm: {
                    "file_count": int(c or 0),
                    "last_modified": lm,
                    "last_indexed": lm,
                },
                pw.right.count,
                pw.right.last_modified,
            ),
        )

    def inputs_query(self, queries: Table) -> Table:
        """reference ``document_store.py:385`` — list indexed input files."""
        files = self.input_table.reduce(
            result=pw.reducers.tuple(
                pw.apply(lambda m: dict(m or {}), pw.this["_metadata"])
            )
        )

        def filter_files(result, metadata_filter, globpattern):
            items = [dict(m) for m in (result or ())]
            merged = _merge_filters(metadata_filter, globpattern)
            if merged is not None:
                items = [m for m in items if merged(m)]
            return items

        return queries.join_left(files, id=queries.id).select(
            result=pw.apply(
                filter_files,
                pw.right.result,
                pw.left.metadata_filter,
                pw.left.filepath_globpattern,
            ),
        )


class SlidesDocumentStore(DocumentStore):
    """Slide-deck variant (reference ``document_store.py:471``); adds the
    parsed-docs listing surface."""

    def parsed_documents_query(self, queries: Table) -> Table:
        assert self._chunks is not None
        docs = self._chunks.reduce(
            result=pw.reducers.tuple(
                pw.apply(
                    lambda t, m: {"text": t, "metadata": dict(m or {})},
                    pw.this.text,
                    pw.this.metadata,
                )
            )
        )
        return queries.join_left(docs, id=queries.id).select(result=pw.right.result)
