"""Question answering over a DocumentStore
(reference ``xpacks/llm/question_answering.py``; counterpart of
``pathway_tpu/xpacks/llm/question_answering.py``).

``BaseRAGQuestionAnswerer`` (reference ``:314``): retrieve -> prompt ->
LLM, served over REST.  ``AdaptiveRAGQuestionAnswerer`` (reference
``:620``) implements the geometric document-count escalation of
``answer_with_geometric_rag_strategy`` (``:97``): start with a few docs,
re-ask with geometrically more until the LLM finds an answer.

As in the JAX package, the adaptive loop retrieves the maximum needed docs
ONCE as-of-now (one score + top-k search) and escalates over prefixes — same
ranking and same LLM call sequence as the reference's repeated
re-retrievals, minus the extra index round-trips.
"""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm import prompts
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.llms import prompt_chat_single_qa
from pathway_tpu_torch.xpacks.llm.servers import QARestServer, QASummaryRestServer

__all__ = [
    "BaseQuestionAnswerer",
    "SummaryQuestionAnswerer",
    "BaseRAGQuestionAnswerer",
    "AdaptiveRAGQuestionAnswerer",
    "answer_with_geometric_rag_strategy",
    "answer_with_geometric_rag_strategy_from_index",
    "DeckRetriever",
]


class BaseQuestionAnswerer:
    """Protocol: table-in/table-out query surfaces (reference ``:288``)."""

    AnswerQuerySchema: type = pw.Schema
    RetrieveQuerySchema: type = pw.Schema
    StatisticsQuerySchema: type = pw.Schema
    InputsQuerySchema: type = pw.Schema

    def answer_query(self, pw_ai_queries: Table) -> Table:
        raise NotImplementedError

    def retrieve(self, retrieval_queries: Table) -> Table:
        raise NotImplementedError

    def statistics(self, info_queries: Table) -> Table:
        raise NotImplementedError

    def list_documents(self, info_queries: Table) -> Table:
        raise NotImplementedError


class SummaryQuestionAnswerer(BaseQuestionAnswerer):
    """adds summarize_query (reference ``:311``)."""

    SummarizeQuerySchema: type = pw.Schema

    def summarize_query(self, summarize_queries: Table) -> Table:
        raise NotImplementedError


def _call_llm(llm: Any, messages: list[dict]) -> str:
    """Invoke a chat UDF host-side (inside another UDF's body)."""
    import inspect

    fun = llm.__wrapped__ if hasattr(llm, "__wrapped__") else llm
    out = fun(messages)
    if inspect.isawaitable(out):
        import asyncio

        out = asyncio.run(out)
    return "" if out is None else str(out)


class BaseRAGQuestionAnswerer(SummaryQuestionAnswerer):
    """reference ``question_answering.py:314``"""

    def __init__(
        self,
        llm: Any,
        indexer: DocumentStore,
        *,
        prompt_template: Callable[[str, list], str] | None = None,
        summarize_template: Any = None,
        search_topk: int = 6,
    ):
        self.llm = llm
        self.indexer = indexer
        self.prompt_template = prompt_template or prompts.prompt_qa_geometric_rag
        self.summarize_template = summarize_template
        self.search_topk = search_topk
        self.server: QARestServer | None = None

    # -- REST schemas (reference :379-448) ------------------------------
    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)
        model: str | None = pw.column_definition(default_value=None)
        return_context_docs: bool | None = pw.column_definition(default_value=False)
        # multi-tenant serving: names the tenant for admission control /
        # SLO-class scheduling; absent → "default" tenant
        tenant: str | None = pw.column_definition(default_value=None)

    class RetrieveQuerySchema(DocumentStore.RetrieveQuerySchema):
        pass

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(DocumentStore.InputsQuerySchema):
        pass

    class SummarizeQuerySchema(pw.Schema):
        text_list: Any

    # -- query surfaces -------------------------------------------------
    def answer_query(self, pw_ai_queries: Table) -> Table:
        """reference ``:451``"""
        as_retrieval = pw_ai_queries.select(
            query=pw_ai_queries.prompt,
            k=pw.apply(lambda _p: self.search_topk, pw_ai_queries.prompt),
            metadata_filter=pw_ai_queries.filters,
            filepath_globpattern=pw.apply(lambda _p: None, pw_ai_queries.prompt),
        )
        with_docs = self.indexer.retrieve_query(as_retrieval)
        combined = pw_ai_queries.with_columns(docs=with_docs.result)

        template = self.prompt_template

        def answer(prompt: str, docs: list, return_context: Any) -> dict:
            docs = list(docs or ())
            text = template(prompt, docs)
            response = _call_llm(self.llm, prompt_chat_single_qa(text))
            out: dict = {"response": response}
            if return_context:
                out["context_docs"] = docs
            return out

        return combined.select(
            result=pw.apply(
                answer, combined.prompt, combined.docs, combined.return_context_docs
            )
        )

    def retrieve(self, retrieval_queries: Table) -> Table:
        return self.indexer.retrieve_query(retrieval_queries)

    def statistics(self, info_queries: Table) -> Table:
        return self.indexer.statistics_query(info_queries)

    def list_documents(self, info_queries: Table) -> Table:
        return self.indexer.inputs_query(info_queries)

    def summarize_query(self, summarize_queries: Table) -> Table:
        """reference ``:500``"""

        def summarize(text_list: Any) -> str:
            texts = list(text_list or ())
            prompt = (
                self.summarize_template(texts)
                if callable(self.summarize_template)
                else f"Summarize the following:\n\n" + "\n".join(map(str, texts))
            )
            return _call_llm(self.llm, prompt_chat_single_qa(prompt))

        return summarize_queries.select(
            result=pw.apply(summarize, summarize_queries.text_list)
        )

    # -- serving --------------------------------------------------------
    def build_server(self, host: str, port: int, **kwargs: Any) -> QASummaryRestServer:
        """reference ``:527``"""
        self.server = QASummaryRestServer(host, port, self, **kwargs)
        return self.server

    def run_server(self, host: str = "0.0.0.0", port: int = 8000, threaded: bool = False, **kwargs: Any):
        """reference ``:600``"""
        if self.server is None:
            self.build_server(host, port)
        return self.server.run(threaded=threaded, **kwargs)


# ---------------------------------------------------------------------------
# Adaptive RAG (reference :97-285, :620)


def answer_with_geometric_rag_strategy(
    questions: list[str],
    documents: list[list[str]],
    llm: Any,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
) -> list[str]:
    """Host-side geometric escalation (reference ``:97``): ask with n docs;
    if the answer is "No information found." retry with n*factor docs."""
    answers = []
    for q, docs in zip(questions, documents):
        n = n_starting_documents
        answer = prompts.NO_INFO
        for _ in range(max_iterations):
            subset = docs[:n]
            text = prompts.prompt_qa_geometric_rag(q, subset)
            answer = _call_llm(llm, prompt_chat_single_qa(text))
            if answer.strip() and prompts.NO_INFO.lower() not in answer.lower():
                break
            if n >= len(docs):
                break
            n *= factor
        answers.append(answer)
    return answers


def answer_with_geometric_rag_strategy_from_index(
    questions: Table,
    index: Any,
    documents_column: Any,
    llm: Any,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    metadata_filter: Any = None,
    strict_prompt: bool = False,
) -> Table:
    """reference ``:162`` — retrieval + geometric answering as a Table op.
    ``documents_column`` names the column of the INDEXED table holding the
    document text (reference semantics); the questions table must have a
    ``query`` column.  Retrieves max-needed docs once as-of-now, escalates
    over prefixes."""
    k_max = n_starting_documents * (factor ** (max_iterations - 1))
    doc_col = (
        documents_column._name
        if hasattr(documents_column, "_name")
        else str(documents_column)
    )
    query_col = questions.query
    replies = index.query_as_of_now(
        query_col, number_of_matches=k_max, metadata_filter=metadata_filter
    )

    def run_strategy(question: str, datas: tuple) -> str:
        docs = [
            str((d or {}).get(doc_col, "")) if isinstance(d, dict) else str(d)
            for d in (datas or ())
        ]
        return answer_with_geometric_rag_strategy(
            [question], [docs], llm, n_starting_documents, factor, max_iterations,
            strict_prompt,
        )[0]

    return replies.select(
        *[replies[c] for c in questions.column_names() if c in replies.column_names()],
        result=pw.apply(run_strategy, query_col, replies["_pw_index_reply"]),
    )


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """reference ``question_answering.py:620``"""

    def __init__(
        self,
        llm: Any,
        indexer: DocumentStore,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs: Any,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, pw_ai_queries: Table) -> Table:
        k_max = self.n_starting_documents * (
            self.factor ** (self.max_iterations - 1)
        )
        as_retrieval = pw_ai_queries.select(
            query=pw_ai_queries.prompt,
            k=pw.apply(lambda _p: k_max, pw_ai_queries.prompt),
            metadata_filter=pw_ai_queries.filters,
            filepath_globpattern=pw.apply(lambda _p: None, pw_ai_queries.prompt),
        )
        with_docs = self.indexer.retrieve_query(as_retrieval)
        combined = pw_ai_queries.with_columns(docs=with_docs.result)

        def answer(prompt: str, docs: list) -> dict:
            texts = [d.get("text", "") for d in (docs or ())]
            response = answer_with_geometric_rag_strategy(
                [prompt], [texts], self.llm, self.n_starting_documents,
                self.factor, self.max_iterations, self.strict_prompt,
            )[0]
            return {"response": response}

        return combined.select(
            result=pw.apply(answer, combined.prompt, combined.docs)
        )


class DeckRetriever(BaseRAGQuestionAnswerer):
    """Slide-deck retrieval app (reference ``:736``): answer = the matched
    slides themselves."""

    def answer_query(self, pw_ai_queries: Table) -> Table:
        as_retrieval = pw_ai_queries.select(
            query=pw_ai_queries.prompt,
            k=pw.apply(lambda _p: self.search_topk, pw_ai_queries.prompt),
            metadata_filter=pw_ai_queries.filters,
            filepath_globpattern=pw.apply(lambda _p: None, pw_ai_queries.prompt),
        )
        with_docs = self.indexer.retrieve_query(as_retrieval)
        return with_docs.select(result=with_docs.result)
