"""Built-in HTML and DOCX text extraction (no external dependencies).

The reference delegates rich-document partitioning to the
``unstructured`` package (``python/pathway/xpacks/llm/parsers.py:79``);
that package (and its system deps) may be absent, so the two most
common rich formats get native extractors in the spirit of the built-in
PDF extractor (``_pdf.py``):

- HTML via :mod:`html.parser` — block-level segmentation with
  unstructured-style element categories (``Title`` for headings,
  ``ListItem`` for ``li``, ``Table`` rows joined per table,
  ``NarrativeText`` otherwise); ``script``/``style`` dropped.
- DOCX via :mod:`zipfile` + :mod:`xml.etree` over ``word/document.xml``
  (a DOCX is a zip of WordprocessingML): paragraphs join their ``w:t``
  runs, ``Heading*`` paragraph styles map to ``Title``, list paragraphs
  (``w:numPr``) to ``ListItem``, and each ``w:tbl`` becomes one
  ``Table`` element with tab-separated cells.

Both return ``list[(text, metadata)]`` blocks; metadata carries the
element ``category`` so DocumentStore chunk filters can use it.

Counterpart of ``pathway_tpu/xpacks/llm/_doc.py``: the same host code over the port's engine.
"""

from __future__ import annotations

import io
import re
import zipfile
from html.parser import HTMLParser
from typing import Any
from xml.etree import ElementTree

__all__ = [
    "extract_html_blocks",
    "extract_docx_blocks",
    "sniff_format",
]

_BLOCK_TAGS = {
    "p", "div", "section", "article", "li", "blockquote", "pre",
    "h1", "h2", "h3", "h4", "h5", "h6", "tr", "br", "td", "th",
}
_HEADINGS = {"h1", "h2", "h3", "h4", "h5", "h6"}
_SKIP_TAGS = {"script", "style", "head", "noscript", "template"}


class _HtmlBlocks(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.blocks: list[tuple[str, dict]] = []
        self._buf: list[str] = []
        self._category = "NarrativeText"
        self._skip_depth = 0
        self._in_table = 0
        self._table_rows: list[str] = []
        self.title: str | None = None
        self._in_title = False

    def _flush(self) -> None:
        text = re.sub(r"\s+", " ", "".join(self._buf)).strip()
        self._buf = []
        category = self._category
        # reset BEFORE the empty-text return: an empty <h1></h1> must not
        # leak Title onto the following paragraph
        self._category = "NarrativeText"
        if not text:
            return
        if self._in_table:
            self._table_rows.append(text)
        else:
            self.blocks.append((text, {"category": category}))

    def handle_starttag(self, tag: str, attrs: Any) -> None:
        if tag in _SKIP_TAGS:
            self._skip_depth += 1
            return
        if tag == "title":
            self._in_title = True
            return
        if tag == "table":
            self._flush()
            self._in_table += 1
            return
        if tag in _BLOCK_TAGS:
            if tag in ("td", "th"):
                self._buf.append("\t")
                return
            self._flush()
            if tag in _HEADINGS:
                self._category = "Title"
            elif tag == "li":
                self._category = "ListItem"

    def handle_endtag(self, tag: str) -> None:
        if tag in _SKIP_TAGS:
            self._skip_depth = max(0, self._skip_depth - 1)
            return
        if tag == "title":
            self._in_title = False
            return
        if tag == "table":
            self._flush()
            self._in_table = max(0, self._in_table - 1)
            if not self._in_table and self._table_rows:
                self.blocks.append(
                    ("\n".join(self._table_rows), {"category": "Table"})
                )
                self._table_rows = []
            return
        if tag in _BLOCK_TAGS and tag not in ("td", "th", "br"):
            self._flush()

    def handle_data(self, data: str) -> None:
        if self._in_title:  # <title> lives inside the skipped <head>
            self.title = (self.title or "") + data.strip()
            return
        if self._skip_depth:
            return
        self._buf.append(data)


def extract_html_blocks(data: bytes | str) -> list[tuple[str, dict]]:
    """Block-segmented text of an HTML document with element categories."""
    if isinstance(data, bytes):
        data = data.decode("utf-8", errors="replace")
    p = _HtmlBlocks()
    p.feed(data)
    p.close()
    p._flush()
    for _text, meta in p.blocks:
        meta["filetype"] = "text/html"
        if p.title:
            meta["page_title"] = p.title
    return p.blocks


_W_NS = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"


def _docx_paragraph_text(par: Any) -> str:
    parts: list[str] = []
    for node in par.iter():
        if node.tag == f"{_W_NS}t" and node.text:
            parts.append(node.text)
        elif node.tag in (f"{_W_NS}tab",):
            parts.append("\t")
        elif node.tag in (f"{_W_NS}br", f"{_W_NS}cr"):
            parts.append("\n")
    return "".join(parts)


def _docx_paragraph_category(par: Any) -> str:
    ppr = par.find(f"{_W_NS}pPr")
    if ppr is not None:
        style = ppr.find(f"{_W_NS}pStyle")
        if style is not None:
            val = style.get(f"{_W_NS}val", "")
            if val.lower().startswith(("heading", "title")):
                return "Title"
        if ppr.find(f"{_W_NS}numPr") is not None:
            return "ListItem"
    return "NarrativeText"


def extract_docx_blocks(data: bytes) -> list[tuple[str, dict]]:
    """Paragraph/table blocks of a DOCX file with element categories."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        xml = zf.read("word/document.xml")
    root = ElementTree.fromstring(xml)
    body = root.find(f"{_W_NS}body")
    if body is None:
        return []
    blocks: list[tuple[str, dict]] = []
    for child in body:
        if child.tag == f"{_W_NS}p":
            text = _docx_paragraph_text(child).strip()
            if text:
                blocks.append(
                    (
                        text,
                        {
                            "category": _docx_paragraph_category(child),
                            "filetype": (
                                "application/vnd.openxmlformats-officedocument"
                                ".wordprocessingml.document"
                            ),
                        },
                    )
                )
        elif child.tag == f"{_W_NS}tbl":
            rows: list[str] = []
            for tr in child.iter(f"{_W_NS}tr"):
                cells = [
                    " ".join(
                        _docx_paragraph_text(p).strip()
                        for p in tc.iter(f"{_W_NS}p")
                    ).strip()
                    for tc in tr.findall(f"{_W_NS}tc")
                ]
                row = "\t".join(c for c in cells if c)
                if row:
                    rows.append(row)
            if rows:
                blocks.append(
                    (
                        "\n".join(rows),
                        {
                            "category": "Table",
                            "filetype": (
                                "application/vnd.openxmlformats-officedocument"
                                ".wordprocessingml.document"
                            ),
                        },
                    )
                )
    return blocks


def sniff_format(data: bytes) -> str:
    """Best-effort content sniffing: 'pdf' | 'docx' | 'html' | 'text'."""
    head = data[:2048].lstrip()
    if head.startswith(b"%PDF"):
        return "pdf"
    if data[:2] == b"PK":
        try:
            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                if "word/document.xml" in zf.namelist():
                    return "docx"
        except zipfile.BadZipFile:
            pass
        return "text"
    low = head[:256].lower()
    if low.startswith(b"<!doctype html") or b"<html" in low or (
        low.startswith(b"<") and b"<body" in head.lower()
    ):
        return "html"
    return "text"
