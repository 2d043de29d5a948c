"""The port's document parsers (``pathway_tpu_torch.xpacks.llm.parsers``)
and their built-in extractors (``_pdf``, ``_doc``, ``_layout``) against
the JAX package's, on the CPU.

Every extractor and parser UDF of both packages reads the same bytes:
the fixtures of ``tests/test_parsers.py`` (the template), and PDFs and
DOCX files generated from seeded synthetic documents by ``chip_smoke.py``
(``make_pdf``, ``make_docx``: the files of the script's phase 21).  Their
outputs, text and metadata, must be equal.  A ``DocumentStore`` with
``OpenParse`` over layout PDFs, on the tiny f32 encoder of
``tests/test_torch_vector_store.py`` with the same weights in both
packages, must retrieve the same chunks with scores within ``F32_TOL``.
"""

from __future__ import annotations

import builtins
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.xpacks.llm import _doc as j_doc
from pathway_tpu.xpacks.llm import _layout as j_layout
from pathway_tpu.xpacks.llm import _pdf as j_pdf
from pathway_tpu.xpacks.llm import parsers as j_parsers
from pathway_tpu_torch.xpacks.llm import _doc as t_doc
from pathway_tpu_torch.xpacks.llm import _layout as t_layout
from pathway_tpu_torch.xpacks.llm import _pdf as t_pdf
from pathway_tpu_torch.xpacks.llm import parsers as t_parsers
from test_parsers import CONTENT, _HTML, _layout_pdf, _minimal_docx, _minimal_pdf
from test_torch_vector_store import F32_TOL, assert_same_hits, dev, embedder, retrieve

DOCS = chip_smoke.synthetic_docs(np, 6, 26)
GENERATED_PDFS = [chip_smoke.make_pdf(d, f"Report {i}", compress=bool(i % 2), pages=1 + i % 3)
                  for i, d in enumerate(DOCS)]
GENERATED_DOCX = [chip_smoke.make_docx(d, f"Memo {i}") for i, d in enumerate(DOCS)]
PDFS = [
    _minimal_pdf(CONTENT, compress=False),
    _minimal_pdf(CONTENT, compress=True),
    _minimal_pdf(b"BT (plain) Tj 0 -14 Td <48692068657821> Tj ET", compress=True),
    _minimal_pdf(b"BT (see (figure 1) here) Tj [(a]b) -100 (c)] TJ <4869> ' ET", compress=False),
    _minimal_pdf(b"BT /F1 10 Tf 12 TL 1 0 0 1 72 700 Tm (first) Tj (second) ' (third) \" ET", compress=False),
    _layout_pdf(),
    *GENERATED_PDFS,
]
DOCX = [_minimal_docx(), *GENERATED_DOCX]
HTML = [_HTML, _HTML.decode(), b"<p>one</p><h2>Two</h2><ol><li>x</li></ol><table><tr><td>a</td></tr></table>"]
ALL = PDFS + DOCX + HTML[:1] + [b"just plain text", b"", "a str document"]


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
    tpw.G.clear()
    yield
    tpw.G.clear()


@pytest.fixture
def no_optional_packages(monkeypatch):
    """The built-in extractors even where ``pypdf`` or ``unstructured`` is
    installed (neither package is a dependency of either package)."""
    real_import = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name.startswith(("pypdf", "unstructured")):
            raise ImportError(f"{name} is kept out of this test")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guarded)


def plain(value):
    """Dataclasses (spans, layout nodes) as plain tuples, for comparing
    across packages."""
    if dataclasses.is_dataclass(value):
        return tuple(plain(getattr(value, f.name)) for f in dataclasses.fields(value))
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def outcome(fn, *args):
    """``fn(*args)``, or the type and message of what it raised."""
    try:
        return ("ok", plain(fn(*args)))
    except Exception as e:  # noqa: BLE001: the exception is what is compared
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# extractors


def test_parser_module_exports_every_jax_name():
    assert set(t_parsers.__all__) == set(j_parsers.__all__)
    for name in j_parsers.__all__:
        assert getattr(t_parsers, name).__module__ == "pathway_tpu_torch.xpacks.llm.parsers"
    assert t_parsers._LATER == ()
    assert t_parsers.UnstructuredParser is t_parsers.ParseUnstructured
    assert issubclass(t_parsers.SlideParser, t_parsers.ImageParser)
    assert tpw.xpacks.llm.parsers is t_parsers


@pytest.mark.parametrize("i", range(len(PDFS)))
def test_pdf_extractors(i):
    data = PDFS[i]
    for name in ("extract_pdf_text",):
        assert outcome(getattr(t_pdf, name), data) == outcome(getattr(j_pdf, name), data)
    for name in ("extract_pdf_spans", "pdf_layout_nodes"):
        got, want = outcome(getattr(t_layout, name), data), outcome(getattr(j_layout, name), data)
        assert got == want and got[0] == "ok"
    for max_chars in (60, 400, 1500):
        assert (outcome(lambda d: t_layout.chunk_pdf_layout(d, max_chars=max_chars), data)
                == outcome(lambda d: j_layout.chunk_pdf_layout(d, max_chars=max_chars), data))


def test_pdf_extractor_rejects_what_the_jax_one_rejects():
    for data in (b"plain text, no header", b"", b"%PDF-1.4\nno streams at all"):
        assert outcome(t_pdf.extract_pdf_text, data) == outcome(j_pdf.extract_pdf_text, data)


@pytest.mark.parametrize("kind", ["docx", "html", "sniff"])
def test_doc_extractors(kind):
    if kind == "docx":
        for data in DOCX + [b"PK\x03\x04 not a zip", b"not a zip"]:
            assert outcome(t_doc.extract_docx_blocks, data) == outcome(j_doc.extract_docx_blocks, data)
    elif kind == "html":
        for data in HTML:
            got = outcome(t_doc.extract_html_blocks, data)
            assert got == outcome(j_doc.extract_html_blocks, data) and got[1]
    else:
        for data in ALL:
            if isinstance(data, bytes):
                assert t_doc.sniff_format(data) == j_doc.sniff_format(data)
        assert [t_doc.sniff_format(d) for d in (PDFS[0], DOCX[0], _HTML, b"hello")] == [
            "pdf", "docx", "html", "text"]


# ---------------------------------------------------------------------------
# parser UDFs


def parsers_of(mod):
    class Chat:
        def __wrapped__(self, messages):
            content = messages[0]["content"]
            if isinstance(content, list):
                return f"image of {len(content[1]['image_url']['url'])} url chars"
            return "| MD TABLE | " + str(len(content))

    return {
        "utf8": mod.ParseUtf8(),
        "unstructured single": mod.ParseUnstructured(),
        "unstructured elements": mod.ParseUnstructured(mode="elements"),
        "unstructured paged": mod.ParseUnstructured(mode="paged"),
        "html single": mod.ParseHtml(),
        "html elements": mod.ParseHtml(mode="elements"),
        "docx single": mod.ParseDocx(),
        "docx elements": mod.ParseDocx(mode="elements"),
        "pypdf": mod.PypdfParser(),
        "pypdf raw": mod.PypdfParser(apply_text_cleanup=False),
        "image parse_fn": mod.ImageParser(parse_fn=lambda b: f"{len(b)} bytes"),
        "image llm": mod.ImageParser(llm=Chat(), parse_prompt="What is shown?"),
        "slide llm": mod.SlideParser(llm=Chat()),
        "openparse": mod.OpenParse(),
        "openparse small": mod.OpenParse(max_chars=120),
        "openparse llm tables": mod.OpenParse(max_chars=400, table_args={"parsing_algorithm": "llm"}, llm=Chat()),
    }


APPLIES = {
    "utf8": ALL, "unstructured single": ALL, "unstructured elements": ALL, "unstructured paged": ALL,
    "html single": HTML, "html elements": HTML, "docx single": DOCX, "docx elements": DOCX,
    "pypdf": PDFS, "pypdf raw": PDFS, "image parse_fn": ALL[:3], "image llm": ALL[:3], "slide llm": ALL[:3],
    "openparse": PDFS, "openparse small": PDFS, "openparse llm tables": PDFS,
}


@pytest.mark.parametrize("name", list(APPLIES))
def test_parser_udfs(name, no_optional_packages):
    port, jax_ = parsers_of(t_parsers)[name], parsers_of(j_parsers)[name]
    produced = 0
    for data in APPLIES[name]:
        if name.startswith(("pypdf", "openparse", "docx")) and isinstance(data, str):
            continue
        got, want = outcome(port.__wrapped__, data), outcome(jax_.__wrapped__, data)
        assert got == want, (name, data[:40])
        produced += got[0] == "ok" and len(got[1]) > 0
    assert produced


def test_parser_argument_errors():
    for mod in (t_parsers, j_parsers):
        with pytest.raises(ValueError, match="invalid mode"):
            mod.ParseUnstructured(mode="bogus")
        with pytest.raises(ValueError, match="invalid mode"):
            mod.ParseHtml(mode="paged")
        with pytest.raises(ValueError, match="invalid mode"):
            mod.ParseDocx(mode="paged")
        with pytest.raises(ValueError, match="llm"):
            mod.OpenParse(table_args={"parsing_algorithm": "llm"})
        with pytest.raises(ValueError, match="algorithm"):
            mod.OpenParse(table_args={"parsing_algorithm": "bogus"})
        with pytest.raises(ValueError, match="needs an llm"):
            mod.ImageParser().__wrapped__(b"png")


def test_openparse_llm_pass_rewrites_only_tables(no_optional_packages):
    calls = []

    class Chat:
        def __wrapped__(self, messages):
            calls.append(messages[0]["content"])
            return "| MD TABLE |"

    chunks = t_parsers.OpenParse(max_chars=400, table_args={"parsing_algorithm": "llm"},
                                 llm=Chat()).__wrapped__(_layout_pdf())
    joined = "\n".join(t for t, _ in chunks)
    assert "led by the north" in joined and "| MD TABLE |" in joined and "Region | Q1 | Q2" not in joined
    assert len(calls) == 1 and "Region | Q1 | Q2" in calls[0] and "led by the north" not in calls[0]


# ---------------------------------------------------------------------------
# a DocumentStore with OpenParse, on the tiny encoder


def layout_store(pw):
    rows = [(data, {"path": f"/docs/report{i}.pdf", "modified_at": i})
            for i, data in enumerate([_layout_pdf(), *GENERATED_PDFS[:4]])]
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=dict), rows)
    st = pw.xpacks.llm.document_store.DocumentStore(
        docs,
        retriever_factory=pw.indexing.BruteForceKnnFactory(embedder=embedder(pw), reserved_space=64, **dev(pw)),
        parser=pw.xpacks.llm.parsers.OpenParse(max_chars=400),
    )
    questions = ["Region Q1 Q2 North South", "Guidance remains unchanged", " ".join(DOCS[1].split()[:12]),
                 "Report 3, part 2"]
    # the first question at a k above the chunk count: every chunk comes back
    return [retrieve(pw, st, q, k=64 if i == 0 else 4) for i, q in enumerate(questions)]


def test_document_store_with_openparse_matches_jax(no_optional_packages):
    want, got = layout_store(jpw), None
    tpw.G.clear()
    got = layout_store(tpw)
    assert F32_TOL == 1e-5
    for g, w in zip(got, want):
        assert_same_hits(g, w)
    assert len(got[0]) > 5
    table_chunk = next(d["text"] for d in got[0] if "Region | Q1 | Q2" in d["text"])
    assert "North | 10 | 14" in table_chunk and "South | 8 | 9" in table_chunk
