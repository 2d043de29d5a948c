"""Prompt templates (reference ``xpacks/llm/prompts.py``)."""

from __future__ import annotations

from pathway_tpu_torch.internals.udfs import udf

__all__ = [
    "prompt_qa",
    "prompt_short_qa",
    "prompt_citing_qa",
    "prompt_summarize",
    "prompt_query_rewrite",
    "prompt_qa_geometric_rag",
]


def _docs_text(docs: list) -> str:
    parts = []
    for d in docs:
        if isinstance(d, dict):
            parts.append(str(d.get("text", d)))
        else:
            parts.append(str(d))
    return "\n\n".join(parts)


NO_INFO = "No information found."


def prompt_qa_geometric_rag(
    query: str,
    docs: list,
    information_not_found_response: str = NO_INFO,
    additional_rules: str = "",
) -> str:
    """Plain-function QA template (used directly inside the adaptive RAG
    loop, reference ``answer_with_geometric_rag_strategy``)."""
    return (
        "Use the below documents to answer the question. If the documents "
        f"do not contain the answer, reply exactly: {information_not_found_response}"
        f"{additional_rules}\n\nDocuments:\n{_docs_text(docs)}\n\n"
        f"Question: {query}\nAnswer:"
    )


#: the same template as a column UDF
prompt_qa = udf(prompt_qa_geometric_rag)


@udf
def prompt_short_qa(query: str, docs: list) -> str:
    return (
        "Answer the question with a short phrase based only on the documents. "
        f"If unknown, reply exactly: {NO_INFO}\n\n"
        f"Documents:\n{_docs_text(docs)}\n\nQuestion: {query}\nAnswer:"
    )


@udf
def prompt_citing_qa(query: str, docs: list) -> str:
    numbered = "\n\n".join(
        f"[{i + 1}] {d.get('text', d) if isinstance(d, dict) else d}"
        for i, d in enumerate(docs)
    )
    return (
        "Answer based on the numbered documents, citing sources like [1]. "
        f"If the answer is not present, reply exactly: {NO_INFO}\n\n"
        f"{numbered}\n\nQuestion: {query}\nAnswer:"
    )


@udf
def prompt_summarize(text_list: list) -> str:
    joined = "\n".join(str(t) for t in text_list)
    return f"Summarize the following texts into a single concise summary:\n\n{joined}\n\nSummary:"


@udf
def prompt_query_rewrite(query: str) -> str:
    return (
        "Rewrite the following user question as a concise search query, "
        f"keeping all key entities:\n\n{query}\n\nSearch query:"
    )


