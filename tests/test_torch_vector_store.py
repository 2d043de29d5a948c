"""The port's RAG serving modules (``pathway_tpu_torch.xpacks.llm``:
``DocumentStore``, ``VectorStoreServer``/``VectorStoreClient``, the REST
servers, question answering, parsers, splitters, prompts) against the JAX
package's, on the CPU.

Both packages run on the same inputs, made from a seed with numpy, and on
the same weights: the tiny f32 encoder of ``tests/test_vector_store.py``
(``TINY``), whose flax parameters both embedders take through ``params=``
(the port's with ``device="cpu"``).  Each pipeline is written once, as a
function of the package module (``build(pw)``).  Retrieved chunks are
compared by text and metadata, and their scores within ``F32_TOL``; the
order among them is not compared (near-ties may fall another way, sums
run in another order).  Statistics, input-file lists, prompts and chat
replies must be equal.

Also: ``VectorStoreServer`` with the default embedder raises on a machine
with no card, and a subprocess that serves one tiny ``/v1/retrieve`` on
the CPU loads no jax, flax, ``pathway_tpu`` or aiohttp module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.models import MINILM_L6
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder
from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder
from test_torch_encoder import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
DEADLINE_S = 60.0
TINY = dataclasses.replace(MINILM_L6, layers=2, hidden=64, heads=4, mlp_dim=128, dtype=jnp.float32)

WORDS = ["apple", "orchard", "banana", "yellow", "tropical", "fruit", "matrix", "kernel", "lattice",
         "quantum", "bread", "sourdough", "rocket", "engine", "river", "stream", "index", "query"]
_rng = np.random.default_rng(23)


def _sentence(rng, n: int) -> str:
    return " ".join(str(w) for w in rng.choice(WORDS, n)) + "."


#: (text, metadata) of each document: some long enough to split in two or more chunks
DOCS = [
    (" ".join(_sentence(_rng, int(_rng.integers(3, 9))) for _ in range(int(_rng.integers(1, 5)))),
     {"path": f"/docs/{i}.txt" if i % 3 else f"/docs/{i}.md", "modified_at": int(i)})
    for i in range(14)
]
QUESTIONS = ["banana fruit", "quantum lattice kernel", "sourdough bread", "rocket engine river", "apple"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


class _Embedders:
    value: dict | None = None


def embedder(pw):
    """The package's embedder on ``TINY``, both on the same flax weights."""
    if _Embedders.value is None:
        params = jax.tree.map(np.asarray, JittedEncoder(TINY).params)
        _Embedders.value = {
            jpw: TPUEncoderEmbedder(config=TINY, params=params),
            tpw: TorchEncoderEmbedder(config=port_config(TINY), params=params, device="cpu"),
        }
    return _Embedders.value[pw]


def dev(pw) -> dict:
    """The device argument of the port's indexes (the JAX package's take none)."""
    return {"device": "cpu"} if pw is tpw else {}


def both(build, *args) -> tuple:
    want = build(jpw, *args)
    tpw.G.clear()
    got = build(tpw, *args)
    return want, got


def rows_of(pw, table) -> list[dict]:
    keys, cols = pw.debug.table_to_dicts(table)
    return [{c: cols[c][k] for c in cols} for k in keys]


def docs_table(pw, docs=DOCS):
    return pw.debug.table_from_rows(
        pw.schema_from_types(data=bytes, _metadata=dict), [(t.encode(), dict(m)) for t, m in docs])


def store(pw, docs, **kwargs):
    return pw.xpacks.llm.document_store.DocumentStore(
        docs,
        retriever_factory=pw.indexing.BruteForceKnnFactory(embedder=embedder(pw), reserved_space=64, **dev(pw)),
        **kwargs,
    )


def retrieve(pw, st, query: str, k: int = 3, metadata_filter=None, glob=None) -> list[dict]:
    q = pw.debug.table_from_rows(
        pw.schema_from_types(query=str, k=int, metadata_filter=str, filepath_globpattern=str),
        [(query, k, metadata_filter, glob)])
    out = st.retrieve_query(q)
    (row,) = rows_of(pw, out.select(out.result))
    return list(row["result"])


def assert_same_hits(got: list[dict], want: list[dict]) -> None:
    """The same chunks (text and metadata), scores within ``F32_TOL``; the
    order among them is not compared."""
    key = lambda d: (d["text"], json.dumps(d["metadata"], sort_keys=True))  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, want))
    by_key = {key(d): d for d in want}
    for d in got:
        w = by_key[key(d)]
        assert abs(d["score"] - w["score"]) <= F32_TOL, (d, w)
        assert d["dist"] == -d["score"]
    scores = [d["score"] for d in got]
    assert scores == sorted(scores, reverse=True)


# ---------------------------------------------------------------------------
# VectorStoreServer and the QA server over HTTP


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def digest_chat(pw):
    """A stand-in chat: replies with a digest of its messages."""

    class DigestChat(pw.xpacks.llm.llms.BaseChat):
        def __wrapped__(self, messages, **kwargs):
            return "digest:" + hashlib.sha256(json.dumps(messages).encode()).hexdigest()[:16]

    return DigestChat()


def post(port: int, route: str, payload: dict):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def write_files(root) -> None:
    """``DOCS`` as files under ``root``, each at its ``modified_at``, in
    ``/docs/...`` paths."""
    for text, meta in DOCS:
        path = root / meta["path"].lstrip("/")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        os.utime(path, (meta["modified_at"], meta["modified_at"]))


def served(pw, root):
    """``VectorStoreServer`` over the files under ``root`` (read by
    ``pw.io.fs.read`` in streaming mode) and a ``BaseRAGQuestionAnswerer``'s
    ``QASummaryRestServer`` over the same store, started by one
    ``run_server(threaded=True)``; the answers to a fixed set of requests,
    with the paths relative to ``root``."""
    llm = pw.xpacks.llm
    docs = pw.io.fs.read(str(root), format="binary", mode="streaming", with_metadata=True)
    server = llm.vector_store.VectorStoreServer(
        docs,
        index_factory=pw.indexing.BruteForceKnnFactory(embedder=embedder(pw), reserved_space=64, **dev(pw)),
        splitter=llm.splitters.TokenCountSplitter(min_tokens=4, max_tokens=12),
    )
    rag = llm.question_answering.BaseRAGQuestionAnswerer(digest_chat(pw), server.document_store, search_topk=4)
    port, qa_port = free_port(), free_port()
    rag.build_server("127.0.0.1", qa_port)
    pw.G.active_scheduler = None
    thread = server.run_server("127.0.0.1", port, threaded=True)
    client = llm.vector_store.VectorStoreClient(port=port)
    out: dict = {}
    try:
        deadline = time.monotonic() + DEADLINE_S
        while True:
            try:
                stats = client.get_vectorstore_statistics()
                if stats["file_count"] == len(DOCS):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the server did not come up"
            time.sleep(0.1)
        out["stats"] = stats
        out["retrieve"] = [client.query(q, k=3) for q in QUESTIONS]
        out["filter"] = client.query("fruit", k=20, metadata_filter="modified_at > `9`")
        out["inputs"] = client.get_input_files(filepath_globpattern="*.md")
        out["inputs_filter"] = client.get_input_files(metadata_filter="modified_at < `3`")
        out["answers"] = [post(qa_port, "/v1/pw_ai_answer", {"prompt": q, "return_context_docs": True})
                          for q in QUESTIONS[:3]]
        out["qa_retrieve"] = [post(qa_port, "/v1/retrieve", {"query": q, "k": 4}) for q in QUESTIONS[:3]]
        out["documents"] = post(qa_port, "/v1/pw_list_documents", {})
        out["summary"] = post(qa_port, "/v1/pw_ai_summary", {"text_list": ["one", "two"]})
        out["glob"] = client.query("fruit", k=5, filepath_globpattern="*.md")
    finally:
        deadline = time.monotonic() + DEADLINE_S
        while pw.G.active_scheduler is None and time.monotonic() < deadline:
            time.sleep(0.02)
        pw.G.active_scheduler.stop()
        thread.join(timeout=DEADLINE_S)
    assert not thread.is_alive()
    return json.loads(json.dumps(out).replace(str(root), ""))


def test_vector_store_server_matches_jax_over_http(tmp_path):
    write_files(tmp_path)
    want, got = both(served, tmp_path)
    assert got["stats"] == want["stats"]
    assert got["stats"]["file_count"] == len(DOCS) and got["stats"]["last_modified"] == len(DOCS) - 1
    for g, w in zip(got["retrieve"], want["retrieve"]):
        assert len(g) == 3
        assert_same_hits(g, w)
    assert_same_hits(got["glob"], want["glob"])
    assert got["glob"] and all(d["metadata"]["path"].endswith(".md") for d in got["glob"])
    assert_same_hits(got["filter"], want["filter"])
    assert got["filter"] and all(d["metadata"]["modified_at"] > 9 for d in got["filter"])
    key = lambda m: m["path"]  # noqa: E731
    assert sorted(got["inputs"], key=key) == sorted(want["inputs"], key=key)
    assert sorted(m["path"] for m in got["inputs"]) == sorted(m["path"] for _, m in DOCS if m["path"].endswith(".md"))
    assert sorted(got["inputs_filter"], key=key) == sorted(want["inputs_filter"], key=key)
    assert sorted(m["modified_at"] for m in got["inputs_filter"]) == [0, 1, 2]
    assert sorted(got["documents"], key=key) == sorted(want["documents"], key=key)
    # some documents split into two or more chunks
    chunks = {}
    for hits in got["retrieve"]:
        for d in hits:
            chunks.setdefault(d["metadata"]["path"], set()).add(d["text"])
    assert any(len(texts) > 1 for texts in chunks.values())
    # QA: the context docs are /v1/retrieve at search_topk, the response
    # the stand-in's digest of the prompt built from them
    for g, w, r in zip(got["answers"], want["answers"], got["qa_retrieve"]):
        assert_same_hits(g["context_docs"], w["context_docs"])
        assert_same_hits(g["context_docs"], r)
        assert g["response"].startswith("digest:")
    assert got["summary"] == want["summary"]


def test_default_embedder_needs_a_card():
    """With no card, the default embedder (``device="cuda"``) raises when
    the server is made; nothing runs on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    docs = docs_table(tpw)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpw.xpacks.llm.vector_store.VectorStoreServer(docs)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpw.xpacks.llm.vector_store.VectorStoreServer(docs, embedder=embedder(tpw))


def test_entry_points_default_to_the_card():
    """C11: every class of the port's LLM xpack that takes ``device=``
    defaults to ``"cuda"``; ``HFPipelineChat`` defaulted to the CPU.  The
    test reads the signatures, so it needs no ``transformers``."""
    import importlib
    import inspect

    defaults = {}
    for mod in ("llms", "embedders", "rerankers", "vector_store", "document_store", "question_answering",
                "servers"):
        m = importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{mod}")
        for name, obj in vars(m).items():
            if inspect.isclass(obj) and obj.__module__ == m.__name__:
                params = inspect.signature(obj.__init__).parameters
                if "device" in params:
                    defaults[name] = params["device"].default
    assert defaults["HFPipelineChat"] == "cuda"
    assert {"TorchEncoderEmbedder", "CrossEncoderReranker", "VectorStoreServer"} <= set(defaults)
    assert set(defaults.values()) == {"cuda"}, defaults


# ---------------------------------------------------------------------------
# the langchain and llama_index constructors (duck-typed components)


class LetterEmbedding:
    """A host-side embedding component: the letter histogram of the text."""

    def _vec(self, text: str) -> list[float]:
        v = np.zeros(26, np.float32)
        for ch in text.lower():
            if "a" <= ch <= "z":
                v[ord(ch) - 97] += 1.0
        return [float(x) for x in v]

    def get_text_embedding(self, text: str) -> list[float]:  # llama_index
        return self._vec(text)

    def embed_documents(self, texts: list[str]) -> list[list[float]]:  # langchain
        return [self._vec(t) for t in texts]


class SentenceSplitter:
    def split_text(self, text: str) -> list[str]:
        return [s.strip() + "." for s in text.split(".") if s.strip()]


def adapters(pw):
    vs = pw.xpacks.llm.vector_store.VectorStoreServer
    out = []
    for make in (
        lambda d: vs.from_llamaindex_components(d, transformations=[SentenceSplitter(), LetterEmbedding()],
                                                **dev(pw)),
        lambda d: vs.from_langchain_components(d, embedder=LetterEmbedding(), splitter=SentenceSplitter(),
                                               **dev(pw)),
    ):
        pw.G.clear()
        server = make(docs_table(pw))
        out.append([retrieve(pw, server.document_store, q, k=4) for q in QUESTIONS[:3]])
    errors = []
    for bad in ([LetterEmbedding(), LetterEmbedding()], [SentenceSplitter()], [object()]):
        with pytest.raises(ValueError) as e:
            vs.from_llamaindex_components(docs_table(pw), transformations=bad, **dev(pw))
        errors.append(str(e.value).split(" ")[0])
    return out, errors


def test_llamaindex_and_langchain_constructors():
    want, got = both(adapters)
    assert got[1] == want[1]
    for g_hits, w_hits in zip(got[0], want[0]):
        for g, w in zip(g_hits, w_hits):
            assert len(g) == 4
            assert_same_hits(g, w)
            # a chunk is one sentence: the splitter ran
            assert all(d["text"].count(".") == 1 for d in g)


# ---------------------------------------------------------------------------
# DocumentStore behaviours (counterparts of tests/test_document_store_behaviors.py)


def statistics_and_inputs(pw):
    st = store(pw, docs_table(pw, DOCS[:4]))
    (stats,) = rows_of(pw, st.statistics_query(pw.debug.table_from_rows(pw.schema_from_types(q=int), [(0,)]).select()))
    pw.G.clear()
    st = store(pw, docs_table(pw, DOCS[:4]))
    q = pw.debug.table_from_rows(pw.schema_from_types(metadata_filter=str, filepath_globpattern=str),
                                 [(None, "*.txt"), ("modified_at >= `2`", None), (None, None)])
    inputs = sorted((sorted(m["path"] for m in r["result"]) for r in rows_of(pw, st.inputs_query(q))))
    return stats["result"], inputs


def test_store_statistics_and_inputs():
    want, got = both(statistics_and_inputs)
    assert got == want
    assert got[0] == {"file_count": 4, "last_modified": 3, "last_indexed": 3}


def filters(pw):
    st = store(pw, docs_table(pw))
    return [retrieve(pw, st, "apple fruit", k=20, glob="*.md"),
            retrieve(pw, st, "apple fruit", k=20, metadata_filter="modified_at > `7` && modified_at < `12`"),
            retrieve(pw, st, "apple fruit", k=20, metadata_filter="not valid ((("),
            retrieve(pw, st, "apple fruit", k=2)]


def test_retrieval_glob_and_metadata_filters():
    want, got = both(filters)
    for g, w in zip(got, want):
        assert_same_hits(g, w)
    assert sorted(d["metadata"]["path"] for d in got[0]) == sorted(
        m["path"] for _, m in DOCS if m["path"].endswith(".md"))
    assert sorted(d["metadata"]["modified_at"] for d in got[1]) == [8, 9, 10, 11]
    assert got[2] == []  # a malformed filter fails closed
    assert len(got[3]) == 2


def post_processors_splitters_and_parser_errors(pw):
    llm = pw.xpacks.llm

    def lower_all(text: str, metadata: dict):
        return text.lower(), {**metadata, "post": True}

    st = store(pw, docs_table(pw, [("MIXED case Document", {"path": "/x.txt"})]), doc_post_processors=[lower_all])
    out = [retrieve(pw, st, "mixed case document", k=1)]
    pw.G.clear()
    part_a = "quantum chromodynamics lattice simulation " * 3
    part_b = "sourdough bread fermentation starter " * 3
    st = store(pw, docs_table(pw, [(part_a + part_b, {"path": "/long.txt"})]),
               splitter=llm.splitters.TokenCountSplitter(min_tokens=3, max_tokens=12))
    out.append(retrieve(pw, st, "sourdough fermentation", k=1))
    pw.G.clear()

    class PickyParser(pw.udfs.UDF):
        def __wrapped__(self, data, **kw):
            if b"\x00" in data:
                raise ValueError("unparseable")
            return [(data.decode(), {})]

    docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=dict),
                                    [(b"good document about apples", {"path": "/good.txt"}),
                                     (b"\x00\x01broken", {"path": "/bad.bin"})])
    out.append(retrieve(pw, store(pw, docs, parser=PickyParser()), "apples", k=5))
    return out


def test_post_processors_splitter_chunks_and_parser_errors():
    want, got = both(post_processors_splitters_and_parser_errors)
    for g, w in zip(got, want):
        assert_same_hits(g, w)
    assert got[0][0]["text"] == "mixed case document" and got[0][0]["metadata"]["post"] is True
    assert "sourdough" in got[1][0]["text"] and got[1][0]["metadata"]["path"] == "/long.txt"
    assert [d["metadata"]["path"] for d in got[2]] == ["/good.txt"]


# ---------------------------------------------------------------------------
# question answering (counterparts of tests/test_xpack_llm.py's cases)


class FakeChat:
    """Answers only when ``answer_if`` is in the prompt; records prompts."""

    def __init__(self, answer_if=None):
        self.calls = []
        self.answer_if = answer_if

    def __wrapped__(self, messages):
        prompt = messages[-1]["content"]
        self.calls.append(prompt)
        if self.answer_if is None or self.answer_if in prompt:
            return "The answer is 42."
        return "No information found."


def answerers(pw):
    qa = pw.xpacks.llm.question_answering
    out = {}
    for name, make in (
        ("base", lambda chat, st: qa.BaseRAGQuestionAnswerer(chat, st, search_topk=3)),
        ("adaptive", lambda chat, st: qa.AdaptiveRAGQuestionAnswerer(
            chat, st, n_starting_documents=1, factor=2, max_iterations=3)),
        ("deck", lambda chat, st: qa.DeckRetriever(chat, st, search_topk=2)),
    ):
        pw.G.clear()
        chat = FakeChat(answer_if=DOCS[5][0].split(".")[0] if name == "adaptive" else None)
        rag = make(chat, store(pw, docs_table(pw)))
        q = pw.debug.table_from_rows(
            pw.schema_from_types(prompt=str, filters=str, model=str, return_context_docs=bool),
            [(QUESTIONS[0], None, None, True)])
        (row,) = rows_of(pw, rag.answer_query(q))
        out[name] = (row["result"], chat.calls)
    chat = FakeChat(answer_if="doc3")
    answers = qa.answer_with_geometric_rag_strategy(["q"], [["doc1", "doc2", "doc3", "doc4"]], chat,
                                                    n_starting_documents=1, factor=2, max_iterations=4)
    out["geometric"] = (answers, chat.calls)
    return out


def test_question_answerers():
    want, got = both(answerers)
    (g, g_calls), (w, w_calls) = got["base"], want["base"]
    assert g["response"] == w["response"] == "The answer is 42."
    assert_same_hits(g["context_docs"], w["context_docs"])
    assert len(g["context_docs"]) == 3 and len(g_calls) == 1 and QUESTIONS[0] in g_calls[0]
    # the prompt lists the same docs (their order may differ among near-ties)
    assert sorted(g_calls[0].splitlines()) == sorted(w_calls[0].splitlines())
    assert got["adaptive"][0] == want["adaptive"][0]
    assert len(got["adaptive"][1]) == len(want["adaptive"][1])
    assert_same_hits(got["deck"][0], want["deck"][0])
    assert got["geometric"] == want["geometric"]
    assert got["geometric"][0] == ["The answer is 42."] and len(got["geometric"][1]) == 3


def hybrid(pw):
    docs = pw.debug.table_from_rows(pw.schema_from_types(text=str),
                                    [("apples grow on trees",), ("bananas are yellow",), ("rocket engine",)])
    queries = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("bananas",)])
    factory = pw.indexing.HybridIndexFactory(retriever_factories=[
        pw.indexing.BruteForceKnnFactory(embedder=embedder(pw), reserved_space=16, **dev(pw)),
        pw.indexing.TantivyBM25Factory(),
    ])
    res = factory.build_data_index(docs.text, docs).query_as_of_now(queries.q, number_of_matches=2)
    (row,) = rows_of(pw, res)
    return [d["text"] for d in row["_pw_index_reply"]], [float(s) for s in row["_pw_index_reply_score"]]


def test_hybrid_index_with_embedder():
    want, got = both(hybrid)
    assert got == want
    assert got[0][0] == "bananas are yellow"


# ---------------------------------------------------------------------------
# prompts, splitters, parsers, rerankers


def test_prompt_templates_embed_docs_and_query():
    docs = [{"text": "alpha passage"}, {"text": "beta passage"}]
    for pw in (jpw, tpw):
        prompts = pw.xpacks.llm.prompts

        def call(f, *args):
            return f.__wrapped__(*args) if isinstance(f, (jpw.UDF, tpw.UDF)) else f(*args)

        for name in ("prompt_qa_geometric_rag", "prompt_short_qa", "prompt_citing_qa", "prompt_qa"):
            out = call(getattr(prompts, name), "why alpha?", docs)
            assert out == call(getattr(jpw.xpacks.llm.prompts, name), "why alpha?", docs)
            assert "why alpha?" in out and "alpha passage" in out and "beta passage" in out
        assert call(prompts.prompt_summarize, ["one", "two"]) == call(jpw.xpacks.llm.prompts.prompt_summarize,
                                                                      ["one", "two"])
        assert "original question" in call(prompts.prompt_query_rewrite, "original question")
    assert tpw.xpacks.llm.llms.prompt_chat_single_qa("q") == jpw.xpacks.llm.llms.prompt_chat_single_qa("q")


@pytest.mark.parametrize("min_tokens, max_tokens", [(5, 10), (10, 30), (1, 100), (50, 500)])
def test_splitters_match_jax(min_tokens, max_tokens):
    rng = np.random.default_rng(24)
    texts = ["word " * 60, "One sentence here. " * 30, "", "   "] + [
        " ".join(_sentence(rng, int(rng.integers(1, 40))) for _ in range(int(rng.integers(1, 8))))
        for _ in range(12)]
    jsp = jpw.xpacks.llm.splitters.TokenCountSplitter(min_tokens=min_tokens, max_tokens=max_tokens)
    tsp = tpw.xpacks.llm.splitters.TokenCountSplitter(min_tokens=min_tokens, max_tokens=max_tokens)
    for text in texts:
        chunks = tsp.__wrapped__(text)
        assert chunks == jsp.__wrapped__(text)
        assert all(isinstance(c, tuple) and c[1] == {} for c in chunks)
        assert all(len(c.split()) <= max_tokens for c, _ in chunks)
    assert len(tsp.__wrapped__("word " * 60)) >= (2 if max_tokens < 60 else 1)
    assert tpw.xpacks.llm.splitters.null_splitter("abc") == jpw.xpacks.llm.splitters.null_splitter("abc") == [
        ("abc", {})]


def test_parse_utf8():
    for contents in (b"plain text", "already str", "ünïcødé ✓".encode(), b"\xff\xfe broken \x80", 42):
        got = tpw.xpacks.llm.parsers.ParseUtf8().__wrapped__(contents)
        assert got == jpw.xpacks.llm.parsers.ParseUtf8().__wrapped__(contents)
        assert len(got) == 1 and isinstance(got[0][0], str)
    assert tpw.xpacks.llm.parsers.Utf8Parser is tpw.xpacks.llm.parsers.ParseUtf8


def test_flashrank_reranker_needs_its_package():
    if "flashrank" in sys.modules or __import__("importlib").util.find_spec("flashrank") is not None:
        pytest.skip("flashrank is installed")
    for pw in (jpw, tpw):
        with pytest.raises(ImportError, match="FlashRankReranker needs the 'flashrank' package"):
            pw.xpacks.llm.rerankers.FlashRankReranker()


# ---------------------------------------------------------------------------
# import hygiene

_HYGIENE = r"""
import dataclasses, json, socket, sys, time, urllib.request
import torch
torch.set_num_threads(1)
import pathway_tpu_torch as pw
import pathway_tpu_torch.io
from pathway_tpu_torch.xpacks.llm import question_answering, vector_store
from pathway_tpu_torch.models import MINILM_L6

tiny = dataclasses.replace(MINILM_L6, layers=1, hidden=32, heads=2, mlp_dim=64, dtype=torch.float32)
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=dict),
                                [(b"apples grow on trees", {"path": "/a.txt"}), (b"rockets fly", {"path": "/b.txt"})])
server = vector_store.VectorStoreServer(docs, index_factory=pw.indexing.BruteForceKnnFactory(
    embedder=pw.TorchEncoderEmbedder(config=tiny, device="cpu"), reserved_space=8, device="cpu"))
thread = server.run_server("127.0.0.1", port, threaded=True)
deadline = time.monotonic() + 60
while True:
    try:
        hits = vector_store.VectorStoreClient(port=port).query("apples", k=1)
        break
    except OSError:
        assert time.monotonic() < deadline
        time.sleep(0.1)
pw.G.active_scheduler.stop()
thread.join(timeout=30)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "pathway_tpu", "aiohttp"))
print(json.dumps({"hits": hits, "bad": bad, "alive": thread.is_alive()}))
"""


def test_serving_imports_no_jax_and_no_aiohttp():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["alive"] is False
    assert len(res["hits"]) == 1 and res["hits"][0]["metadata"]["path"] in ("/a.txt", "/b.txt")
