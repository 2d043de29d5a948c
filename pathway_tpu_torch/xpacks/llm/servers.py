"""REST servers for RAG apps (reference ``xpacks/llm/servers.py:16-272``;
counterpart of ``pathway_tpu/xpacks/llm/servers.py``)."""

from __future__ import annotations

import threading
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

__all__ = [
    "BaseRestServer",
    "DocumentStoreServer",
    "QARestServer",
    "QASummaryRestServer",
]


class BaseRestServer:
    """Route registry over one webserver (reference ``servers.py:16``).

    ``admission`` (optional) is an admission controller with the contract
    of the JAX package's ``serving/admission.py``: every route this server
    registers admits requests against the tenant named by the payload's
    ``tenant_field`` before they enter the engine — a full tenant queue
    sheds with 429 + ``Retry-After`` instead of buffering unboundedly."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        admission: Any = None,
        tenant_field: str = "tenant",
        **kwargs: Any,
    ):
        self.host = host
        self.port = port
        self.admission = admission
        self.tenant_field = tenant_field
        self.webserver = PathwayWebserver(host=host, port=port)

    def serve(
        self,
        route: str,
        schema: Any,
        handler: Callable[[Table], Table],
        **kwargs: Any,
    ) -> None:
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            delete_completed_queries=kwargs.get("delete_completed_queries", False),
            admission=kwargs.get("admission", self.admission),
            tenant_field=kwargs.get("tenant_field", self.tenant_field),
        )
        writer(handler(queries))

    def serve_callable(
        self,
        route: str,
        schema: Any = None,
        callable_func: Callable | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        **additional_endpoint_kwargs: Any,
    ) -> Callable:
        """Expose an arbitrary Python callable (sync or async) as a REST
        endpoint (reference ``xpacks/llm/servers.py:227-272``).

        Each request row runs through an :class:`AsyncTransformer`, so a
        slow or async callable never blocks the engine loop; the HTTP
        response is the callable's return value.  When ``schema`` is
        omitted it is inferred from the callable's argument names (each
        argument becomes a JSON-typed request field).  Usable directly or
        as a decorator::

            @server.serve_callable("/v1/my_fn")
            async def my_fn(query: str): ...
        """
        from pathway_tpu_torch.internals.json import Json
        from pathway_tpu_torch.stdlib.utils.async_transformer import (
            AsyncTransformer,
            coerce_async,
        )

        def decorator(fn: Callable) -> Callable:
            use_schema = schema
            if use_schema is None:
                import inspect

                names = [
                    p.name
                    for p in inspect.signature(fn).parameters.values()
                    if p.kind
                    in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                ]
                use_schema = pw.schema_from_types(**{n: object for n in names})
            async_fn = coerce_async(fn)

            class FuncAsyncTransformer(AsyncTransformer):
                output_schema = pw.schema_from_types(result=object)

                async def invoke(self, **kwargs: Any) -> dict:
                    kwargs = {
                        k: (
                            v.value
                            if isinstance(v, (Json, pw.PyObjectWrapper))
                            else v
                        )
                        for k, v in kwargs.items()
                    }
                    return {"result": await async_fn(**kwargs)}

            def handler(table: Table) -> Table:
                return (
                    FuncAsyncTransformer(input_table=table)
                    .with_options(
                        retry_strategy=retry_strategy,
                        cache_strategy=cache_strategy,
                    )
                    .successful
                )

            self.serve(route, use_schema, handler, **additional_endpoint_kwargs)
            return fn

        if callable_func is None:
            return decorator
        return decorator(callable_func)

    def run(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = False,
        **kwargs: Any,
    ) -> threading.Thread | None:
        """Start the engine (reference ``servers.py:58`` ``run``)."""
        if threaded:
            t = threading.Thread(target=pw.run, daemon=True, name="pw_server")
            t.start()
            return t
        pw.run()
        return None

    run_server = run


class DocumentStoreServer(BaseRestServer):
    """reference ``servers.py:92`` — exposes a DocumentStore over REST:
    /v1/retrieve, /v1/statistics, /v1/inputs."""

    def __init__(self, host: str, port: int, document_store: Any, **kwargs: Any):
        super().__init__(host, port, **kwargs)
        self.document_store = document_store
        ds = document_store
        self.serve("/v1/retrieve", ds.RetrieveQuerySchema, ds.retrieve_query)
        self.serve("/v1/statistics", ds.StatisticsQuerySchema, ds.statistics_query)
        self.serve("/v1/inputs", ds.InputsQuerySchema, ds.inputs_query)


class QARestServer(BaseRestServer):
    """reference ``servers.py:140`` — /v1/pw_ai_answer + document listing
    for a question answerer."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **kwargs: Any):
        super().__init__(host, port, **kwargs)
        self.rag = rag_question_answerer
        self.serve(
            "/v1/pw_ai_answer",
            self.rag.AnswerQuerySchema,
            self.rag.answer_query,
        )
        self.serve(
            "/v1/retrieve",
            self.rag.RetrieveQuerySchema,
            self.rag.retrieve,
        )
        self.serve(
            "/v1/statistics",
            self.rag.StatisticsQuerySchema,
            self.rag.statistics,
        )
        self.serve(
            "/v1/pw_list_documents",
            self.rag.InputsQuerySchema,
            self.rag.list_documents,
        )


class QASummaryRestServer(QARestServer):
    """reference ``servers.py:193`` — adds /v1/pw_ai_summary."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **kwargs: Any):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            self.rag.SummarizeQuerySchema,
            self.rag.summarize_query,
        )
