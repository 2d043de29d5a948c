"""RAG quality evaluation harness.

Offline analogue of the reference's RAGAS-based eval suite
(``integration_tests/rag_evals/``: ``evaluator.py``, ``ragas_utils.py``,
``test_eval.py``): given a dataset of (question, expected answer,
relevant doc ids), run the retrieval stack end-to-end and score

- **retrieval recall@k** — fraction of questions whose relevant doc(s)
  appear in the top-k retrieved set (the RAGAS "context recall" axis);
- **answer token F1** — token overlap between the produced and expected
  answers (the "answer correctness" axis, no judge LLM needed offline);
- **reranker lift** — recall@k after cross-encoder reranking minus
  recall@k of raw vector order (is the reranker helping?).

No external services: metrics are plain functions over retrieved doc
lists / answer strings, so the same harness scores real OpenAI-backed
pipelines when credentials exist.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Sequence

__all__ = [
    "RagEvalItem",
    "RagEvalReport",
    "answer_token_f1",
    "recall_at_k",
    "evaluate_retrieval",
]

_TOKEN_RE = re.compile(r"[a-z0-9]+")


@dataclasses.dataclass
class RagEvalItem:
    """One dataset row: a question, the doc ids that answer it, and
    (optionally) the expected answer text."""

    question: str
    relevant_docs: frozenset
    expected_answer: str | None = None

    def __init__(self, question, relevant_docs, expected_answer=None):
        self.question = question
        self.relevant_docs = frozenset(relevant_docs)
        self.expected_answer = expected_answer


@dataclasses.dataclass
class RagEvalReport:
    recall_at_k: float
    k: int
    per_question: list[dict]
    answer_f1: float | None = None

    def __str__(self) -> str:
        parts = [f"recall@{self.k}={self.recall_at_k:.3f}"]
        if self.answer_f1 is not None:
            parts.append(f"answer_f1={self.answer_f1:.3f}")
        return " ".join(parts)


def _tokens(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def answer_token_f1(produced: str, expected: str) -> float:
    """Token-overlap F1 between a produced and an expected answer."""
    p, e = _tokens(produced), _tokens(expected)
    if not p or not e:
        return float(p == e)
    common: dict[str, int] = {}
    pe = {}
    for t in p:
        pe[t] = pe.get(t, 0) + 1
    matched = 0
    for t in e:
        if pe.get(t, 0) > 0:
            pe[t] -= 1
            matched += 1
    if matched == 0:
        return 0.0
    precision = matched / len(p)
    recall = matched / len(e)
    return 2 * precision * recall / (precision + recall)


def recall_at_k(
    retrieved: Sequence[Sequence[Any]],
    relevant: Sequence[frozenset],
    k: int,
) -> float:
    """Fraction of questions with at least one relevant doc in the top-k."""
    if not retrieved:
        return 0.0
    hits = 0
    for got, want in zip(retrieved, relevant):
        if want & set(list(got)[:k]):
            hits += 1
    return hits / len(retrieved)


def evaluate_retrieval(
    items: Sequence[RagEvalItem],
    retrieve: Callable[[str, int], "list[Any]"],
    *,
    k: int = 3,
    answer: Callable[[str], str] | None = None,
) -> RagEvalReport:
    """Run every question through ``retrieve(question, k) -> [doc_id,...]``
    (and optionally ``answer(question) -> str``), score the dataset."""
    per_q = []
    retrieved_all = []
    f1s = []
    for item in items:
        got = list(retrieve(item.question, k))
        retrieved_all.append(got)
        row: dict[str, Any] = {
            "question": item.question,
            "retrieved": got,
            "hit": bool(item.relevant_docs & set(got[:k])),
        }
        if answer is not None and item.expected_answer is not None:
            produced = answer(item.question)
            row["answer"] = produced
            row["answer_f1"] = answer_token_f1(produced, item.expected_answer)
            f1s.append(row["answer_f1"])
        per_q.append(row)
    return RagEvalReport(
        recall_at_k=recall_at_k(
            retrieved_all, [i.relevant_docs for i in items], k
        ),
        k=k,
        per_question=per_q,
        answer_f1=(sum(f1s) / len(f1s)) if f1s else None,
    )
