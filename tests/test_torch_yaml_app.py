"""The port's ``pw.load_yaml`` (``pathway_tpu_torch/internals/
yaml_loader.py``) and a whole RAG app served from a YAML file, against the
JAX package's, on the CPU.

The loader cases of ``tests/test_stdlib_misc.py`` run through both
packages; a ``!pathway_tpu.`` tag is refused by the port without importing
the JAX package.  ``tests/test_yaml_app.py``'s app (a DocumentStore over a
directory, the tiny f32 encoder, a brute-force index and a question
answerer, in the reference's template form) is written twice, once per
package, with the same flax weights given to both embedders (the port's
``TorchEncoderEmbedder`` takes a flax parameter tree, ``params=``): each is
served over REST, asked the same questions, and scored with each package's
``rag_eval``.  The documents retrieved are the same, in the same order,
with scores within ``F32_TOL``, and the two reports are equal.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.parallel import JittedEncoder

F32_TOL = 1e-5
DOCS = {
    "orchard.txt": "Apples grow on trees in the orchard near the river.",
    "banana.txt": "Bananas are yellow tropical fruit rich in potassium.",
    "tpu.txt": "The TPU systolic array executes matrix multiplications.",
    "bread.txt": "Sourdough bread needs a mature starter and patience.",
    "ocean.txt": "The ocean tide follows the moon's gravitational pull.",
}
QUESTIONS = [
    ("do apples grow on trees in the orchard?", "orchard.txt"),
    ("does the TPU systolic array execute matrix multiplications?", "tpu.txt"),
    ("does the ocean tide follow the moon?", "ocean.txt"),
]

# the reference's template form (integration_tests/rag_evals/app.yaml);
# {embedder} and {device} are each package's
APP_YAML = """
$sources:
  - !pw.io.fs.read
    path: {docs_dir}
    format: binary
    mode: static
    with_metadata: true

$llm: !{helpers}.{chat}

$embedder: !pw.xpacks.llm.embedders.{embedder}
  config: !pw.models.encoder.EncoderConfig
    layers: 2
    hidden: 64
    heads: 4
    mlp_dim: 128
    dtype: {dtype}
  params: !{helpers}.flax_params{device}

$splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  min_tokens: 1
  max_tokens: 100

$parser: !pw.xpacks.llm.parsers.ParseUtf8

$retriever_factory: !pw.stdlib.indexing.BruteForceKnnFactory
  reserved_space: 64
  embedder: $embedder{device}

$document_store: !pw.xpacks.llm.document_store.DocumentStore
  docs: $sources
  parser: $parser
  splitter: $splitter
  retriever_factory: $retriever_factory

question_answerer: !pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer
  llm: $llm
  indexer: $document_store
  search_topk: 2

host: "127.0.0.1"
port: {port}
"""

HELPERS = "yamlapp_helpers_torch"
HELPER_MODULE = '''
"""Deterministic chats for the YAML app test (each package's BaseChat):
they answer with the first context passage, so answer quality reflects
retrieval quality; and the flax weights both embedders get."""
from pathway_tpu.xpacks.llm.llms import BaseChat as JaxBaseChat
from pathway_tpu_torch.xpacks.llm.llms import BaseChat as TorchBaseChat

PARAMS = None


def flax_params():
    return PARAMS


def _echo(messages):
    content = messages[0]["content"] if messages else ""
    if "Documents:" in content:
        after = content.split("Documents:", 1)[1].split("Question:", 1)[0]
        return next((p for p in after.split("\\n") if p.strip()), "").strip()
    return content[:100]


class JaxEchoChat(JaxBaseChat):
    def __wrapped__(self, messages, **kwargs):
        return _echo(messages)


class TorchEchoChat(TorchBaseChat):
    def __wrapped__(self, messages, **kwargs):
        return _echo(messages)
'''


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_graphs():
    for pw in (jpw, tpw):
        pw.G.clear()
    yield
    for pw in (jpw, tpw):
        pw.G.clear()


# ---------------------------------------------------------------------------
# the loader


def load_vars_and_tags(pw):
    return pw.load_yaml("""
dim: 4
splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  min_tokens: 2
  max_tokens: $dim
""")


def test_load_yaml_vars_and_tags():
    want, got = load_vars_and_tags(jpw), load_vars_and_tags(tpw)
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    assert got["dim"] == want["dim"] == 4
    assert isinstance(got["splitter"], TokenCountSplitter)
    assert got["splitter"].max_tokens == want["splitter"].max_tokens == 4
    assert got["splitter"].min_tokens == want["splitter"].min_tokens == 2


def test_yaml_forward_reference():
    text = "\npipeline:\n  size: $dim\ndim: 7\n"
    assert tpw.load_yaml(text) == jpw.load_yaml(text) == {"pipeline": {"size": 7}, "dim": 7}


def test_load_yaml_private_keys_and_escape():
    text = "\n$hidden: 41\nvisible: $hidden\n$$literal: 7\nalso: $$literal\n"
    assert tpw.load_yaml(text) == jpw.load_yaml(text) == {"visible": 41, "$literal": 7, "also": 7}
    for pw in (jpw, tpw):
        with pytest.raises(KeyError, match="same variable name"):
            pw.load_yaml("$x: 1\nx: 2")
    assert tpw.load_yaml("1: a\nb: 2") == jpw.load_yaml("1: a\nb: 2") == {1: "a", "b": 2}


def test_load_yaml_tag_prefixes_of_the_port():
    for prefix in ("pw", "pathway", "pathway_tpu_torch"):
        cfg = tpw.load_yaml(f"s: !{prefix}.xpacks.llm.splitters.TokenCountSplitter\n  max_tokens: 9\n")
        assert type(cfg["s"]).__module__ == "pathway_tpu_torch.xpacks.llm.splitters"
        assert cfg["s"].max_tokens == 9


def test_load_yaml_refuses_the_jax_prefix():
    """A ``!pathway_tpu.`` tag names the JAX package: the port refuses it,
    naming its own prefix, and imports nothing of that package (checked
    in a fresh process where importing it fails)."""
    with pytest.raises(ValueError, match=r"!pathway_tpu_torch\.xpacks\.llm\.splitters\.TokenCountSplitter"):
        tpw.load_yaml("s: !pathway_tpu.xpacks.llm.splitters.TokenCountSplitter\n  max_tokens: 9\n")
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'pathway_tpu'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pathway_tpu_torch as pw\n"
        "try:\n"
        "    pw.load_yaml('s: !pathway_tpu.xpacks.llm.splitters.TokenCountSplitter')\n"
        "except ValueError as e:\n"
        "    print('refused:', e)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pathway_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("refused: yaml tag !pathway_tpu.") and lines[-1] == "[]"


# ---------------------------------------------------------------------------
# tests/test_yaml_app.py's RAG app, served from each package's YAML


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url: str, payload: dict, timeout: float = 10.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def serve_app(pw, tmp_path) -> dict:
    """The package's YAML app served over REST: each question's retrieved
    (file, score) list at k = len(DOCS), its answer, and the rag_eval
    report over the questions at k=2."""
    import importlib

    rag_eval = importlib.import_module(f"{pw.__name__}.xpacks.llm.rag_eval")
    port_pkg = pw is tpw
    text = APP_YAML.format(
        docs_dir=str(tmp_path / "docs"), helpers=HELPERS, port=(port := _free_port()),
        chat="TorchEchoChat" if port_pkg else "JaxEchoChat",
        embedder="TorchEncoderEmbedder" if port_pkg else "TPUEncoderEmbedder",
        dtype="!torch.float32" if port_pkg else "float32",
        device="\n  device: cpu" if port_pkg else "",
    )
    pw.G.clear()
    app = pw.load_yaml(text)
    qa = app["question_answerer"]
    assert qa.run_server(app["host"], app["port"], threaded=True) is not None
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        listed = None
        while time.monotonic() < deadline:
            try:
                listed = _post(f"{base}/v1/pw_list_documents", {})
                if listed and len(listed) == len(DOCS):
                    break
            except Exception:
                pass
            time.sleep(0.3)
        assert listed and len(listed) == len(DOCS), "the server did not come up with every document"

        def retrieve_scored(question: str, k: int) -> list[tuple[str, float]]:
            out = _post(f"{base}/v1/retrieve", {"query": question, "k": k})
            return [(d["metadata"]["path"].rsplit("/", 1)[-1], float(d["dist"])) for d in out]

        def answer(question: str) -> str:
            out = _post(f"{base}/v1/pw_ai_answer", {"prompt": question})
            return str(out.get("response", out) if isinstance(out, dict) else out)

        items = [rag_eval.RagEvalItem(q, {doc}, expected_answer=DOCS[doc]) for q, doc in QUESTIONS]
        report = rag_eval.evaluate_retrieval(
            items, lambda q, k: [name for name, _ in retrieve_scored(q, k)], k=2, answer=answer)
        return {"retrieved": [retrieve_scored(q, len(DOCS)) for q, _ in QUESTIONS],
                "answers": [answer(q) for q, _ in QUESTIONS], "report": report}
    finally:
        sched = getattr(pw.G, "active_scheduler", None)
        if sched is not None:
            sched.stop()


def test_yaml_rag_app_matches_jax(tmp_path):
    (tmp_path / "docs").mkdir()
    for name, text in DOCS.items():
        (tmp_path / "docs" / name).write_text(text)
    (tmp_path / f"{HELPERS}.py").write_text(HELPER_MODULE)
    sys.path.insert(0, str(tmp_path))
    try:
        import importlib

        helpers = importlib.import_module(HELPERS)
        jcfg = jpw.models.encoder.EncoderConfig(layers=2, hidden=64, heads=4, mlp_dim=128, dtype="float32")
        helpers.PARAMS = jax.tree.map(np.asarray, JittedEncoder(jcfg).params)
        want = serve_app(jpw, tmp_path)
        got = serve_app(tpw, tmp_path)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop(HELPERS, None)
    for w, g in zip(want["retrieved"], got["retrieved"]):
        assert [name for name, _ in g] == [name for name, _ in w]
        assert np.allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=F32_TOL), (g, w)
    assert got["answers"] == want["answers"]
    assert dataclasses.asdict(got["report"]) == dataclasses.asdict(want["report"])
    assert got["report"].recall_at_k >= 0.66, got["report"]
    assert got["report"].answer_f1 is not None and got["report"].answer_f1 >= 0.4, got["report"]
