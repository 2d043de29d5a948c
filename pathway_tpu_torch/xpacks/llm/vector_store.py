"""VectorStoreServer / VectorStoreClient
(reference ``xpacks/llm/vector_store.py:39-766``; counterpart of
``pathway_tpu/xpacks/llm/vector_store.py``).

The server is DocumentStore + REST routes with embedding done inside the
server (the encoder on the card, one batched call per engine epoch) into
the card-resident KNN slab; the client is a thin HTTP wrapper.  LangChain
/ LlamaIndex adapter constructors keep the reference API shape.  Without
an ``index_factory`` the server embeds with
:class:`~pathway_tpu_torch.TorchEncoderEmbedder` and indexes with
:class:`~pathway_tpu_torch.stdlib.indexing.BruteForceKnnFactory`, both on
``device`` (default ``"cuda"``: a machine with no card raises when the
server is made, unless the caller asks for ``"cpu"``).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Callable

import torch

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import (
    BruteForceKnnFactory,
    InnerIndexFactory,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

__all__ = ["VectorStoreServer", "VectorStoreClient"]


class VectorStoreServer:
    """reference ``vector_store.py:39``"""

    def __init__(
        self,
        *docs: Table,
        embedder: Any = None,
        parser: Any = None,
        splitter: Any = None,
        doc_post_processors: list[Callable] | None = None,
        index_factory: InnerIndexFactory | None = None,
        reserved_space: int = 1024,
        mesh: Any = None,
        delta_cap: int | None = None,
        tombstone_fraction: float | None = None,
        auto_merge: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        if embedder is None and index_factory is None:
            from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder

            embedder = TorchEncoderEmbedder(device=device)
        if index_factory is None:
            # delta_cap/tombstone_fraction/auto_merge tune the live index
            # maintenance layer (delta segment + background merge) the
            # built index runs under; see stdlib/indexing/segments.py
            index_factory = BruteForceKnnFactory(
                embedder=embedder,
                reserved_space=reserved_space,
                mesh=mesh,
                delta_cap=delta_cap,
                tombstone_fraction=tombstone_fraction,
                auto_merge=auto_merge,
                device=device,
            )
        self.docs = docs
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )
        self._server: DocumentStoreServer | None = None

    @classmethod
    def from_langchain_components(
        cls,
        *docs: Table,
        embedder: Any,
        splitter: Any = None,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ) -> "VectorStoreServer":
        """reference ``vector_store.py:93``; the embeddings go into the KNN
        slab on ``device``."""
        from pathway_tpu_torch.internals.udfs import udf

        @udf
        def lc_embed(text: str) -> Any:
            return embedder.embed_documents([text])[0]

        lc_split = None
        if splitter is not None:

            @udf
            def lc_split(text: str) -> list[tuple[str, dict]]:  # noqa: F811
                return [(c, {}) for c in splitter.split_text(text)]

        factory = BruteForceKnnFactory(embedder=lc_embed, device=device)
        return cls(*docs, index_factory=factory, splitter=lc_split, **kwargs)

    @classmethod
    def from_llamaindex_components(
        cls,
        *docs: Table,
        transformations: list,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ) -> "VectorStoreServer":
        """Build from a llama_index transformation pipeline (reference
        ``vector_store.py:137``).  Duck-typed like the langchain adapter —
        no llama_index import: the embedding component is recognised by
        ``get_text_embedding`` (BaseEmbedding protocol), text splitters by
        ``split_text`` (NodeParser/TextSplitter protocol).  The embeddings go
        into the KNN slab on ``device``."""
        from pathway_tpu_torch.internals.udfs import udf

        embed_component = None
        split_components = []
        for tr in transformations:
            if hasattr(tr, "get_text_embedding"):
                if embed_component is not None:
                    raise ValueError(
                        "transformations contain more than one embedding "
                        "component (get_text_embedding)"
                    )
                embed_component = tr
            elif hasattr(tr, "split_text"):
                split_components.append(tr)
            else:
                raise ValueError(
                    f"unsupported llama_index transformation {tr!r}: expected "
                    "an embedding (get_text_embedding) or a text splitter "
                    "(split_text)"
                )
        if embed_component is None:
            raise ValueError(
                "transformations must include an embedding component "
                "(get_text_embedding)"
            )

        @udf
        def li_embed(text: str) -> Any:
            return embed_component.get_text_embedding(text)

        li_split = None
        if split_components:

            @udf
            def li_split(text: str) -> list[tuple[str, dict]]:  # noqa: F811
                chunks = [text]
                for sp in split_components:  # chained splitters, in order
                    chunks = [c for ch in chunks for c in sp.split_text(ch)]
                return [(c, {}) for c in chunks]

        factory = BruteForceKnnFactory(embedder=li_embed, device=device)
        return cls(*docs, index_factory=factory, splitter=li_split, **kwargs)

    def run_server(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        *,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = False,
        admission: Any = None,
        tenant_field: str = "tenant",
    ) -> threading.Thread | None:
        """reference ``vector_store.py:478``; ``admission`` bounds the
        ingress per tenant (the admission contract of the JAX package's
        ``serving/admission.py``) — full queues shed with 429 + Retry-After
        instead of buffering unboundedly."""
        self._server = DocumentStoreServer(
            host,
            port,
            self.document_store,
            admission=admission,
            tenant_field=tenant_field,
        )
        return self._server.run(threaded=threaded, with_cache=with_cache)


class VectorStoreClient:
    """reference ``vector_store.py:651``"""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: float = 60,
    ):
        if url is None:
            if port is None:
                raise ValueError("VectorStoreClient needs a port (or a full url)")
            url = f"http://{host or '127.0.0.1'}:{port}"
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, route: str, payload: dict) -> Any:
        req = urllib.request.Request(
            self.url + route,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        return self._post(
            "/v1/inputs",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )
