"""The port's retrieval UDFs (ROADMAP item 13) against the JAX package's,
on the CPU: the rerankers as UDFs inside pipelines, ``rerank_topk_filter``
as a ``@udf``, ``LLMReranker`` over a fake chat, and the API embedders over
client modules stubbed in ``sys.modules`` (no network call is made).

Each pipeline is written once as ``build(pw)`` and runs through both
packages on the same inputs; the rerankers share the flax parameters of
the tiny f32 ``BGE_RERANKER_BASE`` variant of ``tests/test_torch_rerank.py``
(carried into the port by ``params=``).  Scores are compared per row id at
1e-5 (f32; two layers of f32 sums in another order); filtered lists, LLM
ratings and stubbed embeddings are equal.  Also: a factory, adapter or reranker made
with no ``device=`` raises on a machine with no card, and a process that
imports the port's ``stdlib.indexing`` and ``xpacks.llm`` and runs a
pipeline loads no module of jax, flax or ``pathway_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.models import BGE_RERANKER_BASE as JAX_RERANKER
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm import rerankers as jrr
from pathway_tpu_torch import kernels
from pathway_tpu_torch.xpacks.llm import embedders as temb
from pathway_tpu_torch.xpacks.llm import rerankers as trr
from test_torch_encoder import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dataclasses.replace(JAX_RERANKER, layers=2, hidden=64, heads=4, mlp_dim=128, dtype=jnp.float32)
TINY_BI = dataclasses.replace(TINY, num_labels=0, pool="mean", normalize=True)
TOL = 1e-5

_rng = np.random.default_rng(3)
_WORDS = [f"w{i}" for i in range(200)] + ["stream", "index", "gpu", "rag"]
QUERIES = [" ".join(_rng.choice(_WORDS, int(_rng.integers(2, 8)))) for _ in range(4)]
PAIRS = [(" ".join(_rng.choice(_WORDS, int(_rng.integers(5, 60)))), QUERIES[i % 4]) for i in range(11)]


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


@pytest.fixture(scope="module")
def cross_params():
    return jax.tree.map(np.asarray, JittedEncoder(TINY, cross=True, seed=0).params)


@pytest.fixture(scope="module")
def bi_params():
    return jax.tree.map(np.asarray, JittedEncoder(TINY_BI, seed=1).params)


def run(pw, build) -> dict:
    """``build(pw)``'s table through ``pw.debug``: {row id: row}."""
    pw.G.clear()
    keys, cols = pw.debug.table_to_dicts(build(pw))
    pw.G.clear()
    names = list(cols)
    return {int(k): tuple(cols[c][k] for c in names) for k in keys}


def pairs_table(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(doc=str, q=str), PAIRS)


def score_pairs_with(make):
    def build(pw):
        t = pairs_table(pw)
        return t.select(t.q, score=make(pw)(t.doc, t.q))

    return build


def assert_scores_match(got: dict, want: dict, tol: float) -> None:
    assert got.keys() == want.keys() and len(want) == len(PAIRS)
    for key, (q, score) in want.items():
        assert got[key][0] == q
        assert isinstance(got[key][1], float) and np.isfinite(got[key][1])
        assert abs(got[key][1] - score) <= tol, (got[key][1], score)


@pytest.mark.parametrize("max_batch_size", [64, 4], ids=["one_chunk", "three_chunks"])
def test_cross_encoder_reranker_udf_matches_jax(cross_params, max_batch_size):
    calls: list[int] = []

    class Counting(trr.CrossEncoderReranker):
        def __batch__(self, docs, queries):
            calls.append(len(docs))
            return super().__batch__(docs, queries)

    def make(pw):
        if pw is tpw:
            return Counting(config=port_config(TINY), params=cross_params, max_batch_size=max_batch_size,
                            device="cpu")
        return jrr.CrossEncoderReranker(config=TINY, params=cross_params, max_batch_size=max_batch_size)

    before = dict(kernels.launch_counts())
    got = run(tpw, score_pairs_with(make))
    assert dict(kernels.launch_counts()) == before  # CPU tensors: the plain versions only
    assert_scores_match(got, run(jpw, score_pairs_with(make)), TOL)
    assert sorted(calls) == ([11] if max_batch_size == 64 else [3, 4, 4])


def test_cross_encoder_reranker_is_a_udf(cross_params):
    rr = trr.CrossEncoderReranker(config=port_config(TINY), params=cross_params, max_batch_size=8, device="cpu")
    assert isinstance(rr, tpw.UDF) and rr.max_batch_size == 8
    assert rr.encoder.max_batch == 8
    doc, q = PAIRS[0]
    assert abs(rr.__wrapped__(doc, q) - rr.__batch__([doc], [q])[0]) == 0.0


def test_encoder_reranker_udf_matches_jax(bi_params):
    def make(pw):
        if pw is tpw:
            e = temb.TorchEncoderEmbedder(config=port_config(TINY_BI), params=bi_params, device="cpu")
            return trr.EncoderReranker(embedder=e)
        return jrr.EncoderReranker(embedder=jemb.TPUEncoderEmbedder(config=TINY_BI, params=bi_params))

    assert_scores_match(run(tpw, score_pairs_with(make)), run(jpw, score_pairs_with(make)), TOL)


def topk_pipeline(pw):
    """``rerank_topk_filter`` as a UDF in a pipeline (the counterpart of
    ``tests/test_rag_components.py``'s ``test_rerank_topk_filter_in_pipeline``),
    with a per-row k and a tie."""
    t = pw.debug.table_from_rows(
        pw.schema_from_types(docs=tuple, scores=tuple, k=int),
        [
            (("d1", "d2", "d3", "d4"), (0.1, 0.9, 0.5, 0.7), 2),
            (("a", "b", "c"), (0.3, 0.3, 0.2), 2),
            (({"text": "x"}, {"text": "y"}), (-1.0, 2.0), 5),
        ],
    )
    filt = pw.xpacks.llm.rerankers.rerank_topk_filter
    return t.select(top=filt(t.docs, t.scores, t.k))


def test_rerank_topk_filter_udf_in_pipeline_matches_jax():
    got = run(tpw, topk_pipeline)
    assert got == run(jpw, topk_pipeline)
    tops = [(list(d), list(s)) for ((d, s),) in got.values()]
    assert (["d2", "d4"], [0.9, 0.7]) in tops and ([{"text": "y"}, {"text": "x"}], [2.0, -1.0]) in tops
    assert isinstance(trr.rerank_topk_filter, tpw.UDF)
    assert trr.rerank_topk_filter.__wrapped_fun__(["a", "b"], [0.0, 1.0], 1) == (["b"], [1.0])


class FakeChat:
    """A chat model: a rating from the document's length, or a reply that
    is not a number where that length is a multiple of 7."""

    def __wrapped__(self, messages, **kw):
        doc = messages[0]["content"].split("Document: ")[-1]
        return "no idea" if len(doc) % 7 == 0 else f" {len(doc) % 5 + 1}\n"


def test_llm_reranker_udf_matches_jax():
    def build(pw):
        t = pairs_table(pw)
        llm_rr = (trr if pw is tpw else jrr).LLMReranker(llm=FakeChat())
        return t.select(t.q, score=llm_rr(t.doc, t.q))

    got = run(tpw, build)
    assert got == run(jpw, build)
    scores = [s for _, s in got.values()]
    assert set(scores) <= {1.0, 2.0, 3.0, 4.0, 5.0} and len(set(scores)) > 1
    rr = trr.LLMReranker(llm=FakeChat())
    assert isinstance(rr, tpw.UDF)
    assert [rr.__wrapped__("abc", "q"), rr.__wrapped__("abcd", "q"), rr.__wrapped__("1234567", "q")] == [4.0, 5.0, 1.0]


# ---------------------------------------------------------------------------
# the API embedders over stubbed clients


def _vector(text: str) -> list[float]:
    r = np.random.default_rng(sum(map(ord, text)))
    return r.standard_normal(6).tolist()


def _stub_clients(monkeypatch) -> list:
    """Client modules in ``sys.modules`` answering with a vector made from
    the text; returns the list of calls they saw."""
    seen: list = []

    class _Embeddings:
        async def create(self, input, **kw):
            seen.append(("openai", input, kw))
            return types.SimpleNamespace(data=[types.SimpleNamespace(embedding=_vector(input[0]))])

    class AsyncOpenAI:
        def __init__(self):
            self.embeddings = _Embeddings()

    async def aembedding(input, **kw):
        seen.append(("litellm", input, kw))
        return types.SimpleNamespace(data=[{"embedding": _vector(input[0])}])

    def embed_content(content, **kw):
        seen.append(("gemini", content, kw))
        return {"embedding": _vector(content)}

    genai = types.ModuleType("google.generativeai")
    genai.embed_content = embed_content
    google = types.ModuleType("google")
    google.generativeai = genai
    for name, mod in (("openai", types.ModuleType("openai")), ("litellm", types.ModuleType("litellm")),
                      ("google", google), ("google.generativeai", genai)):
        monkeypatch.setitem(sys.modules, name, mod)
    sys.modules["openai"].AsyncOpenAI = AsyncOpenAI
    sys.modules["litellm"].aembedding = aembedding
    return seen


API = ["OpenAIEmbedder", "LiteLLMEmbedder", "GeminiEmbedder"]


@pytest.mark.parametrize("name", API)
def test_api_embedder_udf_matches_jax_with_a_stub_client(monkeypatch, name):
    seen = _stub_clients(monkeypatch)

    def build(pw):
        cls = getattr(temb if pw is tpw else jemb, name)
        t = pw.debug.table_from_rows(pw.schema_from_types(text=str), [("alpha",), ("beta gamma",), ("",)])
        return t.select(t.text, emb=cls(model="m-1", dimensions=6)(t.text))

    got = run(tpw, build)
    n_calls = len(seen)
    want = run(jpw, build)
    assert n_calls == 3 and len(seen) == 6
    assert got.keys() == want.keys()
    for key in want:
        assert got[key][0] == want[key][0]
        np.testing.assert_array_equal(got[key][1], want[key][1])
        np.testing.assert_array_equal(got[key][1], _vector(want[key][0] or "."))
    assert seen[:n_calls] == seen[n_calls:] or sorted(map(repr, seen[:n_calls])) == sorted(map(repr, seen[n_calls:]))
    assert all(call[2].get("model") == "m-1" and call[2].get("dimensions") == 6 for call in seen)
    embedder = getattr(temb, name)(model="m-1")
    assert isinstance(embedder, temb.BaseEmbedder) and embedder.get_embedding_dimension() == 6


@pytest.mark.parametrize("name", API)
def test_api_embedder_without_its_client_raises_import_error(monkeypatch, name):
    pkg = getattr(temb, name)._client_pkg
    monkeypatch.setitem(sys.modules, pkg, None)  # an import of it now fails
    with pytest.raises(ImportError, match=pkg):
        getattr(temb, name)()
    with pytest.raises(ImportError, match=pkg):
        getattr(jemb, name)()


# ---------------------------------------------------------------------------
# no card: the defaults raise; import hygiene


def test_no_card_factories_adapters_and_rerankers_raise(cross_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from pathway_tpu_torch.stdlib.indexing.adapters import IvfAdapter, KnnAdapter

    t = tpw.debug.table_from_rows(tpw.schema_from_types(text=str), [("a",)])
    made = [
        lambda: tpw.indexing.BruteForceKnnFactory(dimensions=4),
        lambda: tpw.indexing.UsearchKnnFactory(dimensions=4, nlist=4, nprobe=2),
        lambda: tpw.indexing.LshKnnFactory(dimensions=4),
        lambda: tpw.indexing.VectorDocumentIndex(t.text, t, None, dimensions=4),
        lambda: KnnAdapter(4),
        lambda: IvfAdapter(4),
        lambda: trr.CrossEncoderReranker(config=port_config(TINY), params=cross_params),
        lambda: trr.EncoderReranker(),
    ]
    for make in made:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_port_retrieval_imports_no_jax():
    """A fresh process imports the port's ``stdlib.indexing`` and
    ``xpacks.llm``, runs a KNN pipeline and a reranker UDF on the CPU, and
    has loaded no module of jax, flax or ``pathway_tpu``."""
    code = """
import json, sys, dataclasses
import pathway_tpu_torch.stdlib.indexing as indexing
import pathway_tpu_torch.xpacks.llm as llm
import pathway_tpu_torch as pw
from pathway_tpu_torch.models import BGE_RERANKER_BASE
cfg = dataclasses.replace(BGE_RERANKER_BASE, layers=1, hidden=32, heads=2, mlp_dim=64)
docs = pw.debug.table_from_rows(pw.schema_from_types(text=str, v=tuple),
                                [("a b", (1.0, 0.0)), ("c d", (0.0, 1.0)), ("e", (1.0, 1.0))])
q = pw.debug.table_from_rows(pw.schema_from_types(qv=tuple), [((1.0, 0.1),)])
res = indexing.BruteForceKnnFactory(dimensions=2, device="cpu").build_data_index(docs.v, docs).query_as_of_now(
    q.qv, number_of_matches=2, collapse_rows=False)
rr = llm.CrossEncoderReranker(config=cfg, device="cpu")
scored = res.select(doc=pw.apply(lambda d: d["text"], res["_pw_index_reply"]), s=rr(pw.apply(lambda d: d["text"],
                    res["_pw_index_reply"]), "a question"))
keys, cols = pw.debug.table_to_dicts(scored)
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "pathway_tpu"))
print(json.dumps({"docs": sorted(cols["doc"].values()), "foreign": foreign}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"docs": ["a b", "e"], "foreign": []}
