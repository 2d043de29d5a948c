"""Layout-aware PDF chunking (reference
``python/pathway/xpacks/llm/openparse_utils.py`` + the ``openparse``
package it wraps: bbox-positioned text nodes, heading detection, table
detection, and chunk merging).

The reference delegates layout analysis to pymupdf/openparse; this
module derives the same structure from the PDF content streams directly
(no third-party dependency), on top of the tokenizer in ``_pdf.py``:

- **spans**: every shown string with its (x, y) from the text matrix
  (``Tm``/``Td``/``TD``/``T*``) and font size (``Tf`` scaled by ``Tm``),
- **lines**: spans grouped by baseline y, sorted by x,
- **columns**: lines clustered by x-extent gaps, read column-major
  (left column top-to-bottom, then the next) — multi-column PDFs come
  out in reading order instead of interleaved,
- **headings**: lines whose font size clears the body median by >=15%,
- **tables**: >=2 consecutive lines whose >=2 span x-positions align
  within a tolerance — emitted as one node with ``" | "`` cell
  separators, never split across chunks,
- **chunks**: nodes merged in reading order up to a character budget;
  headings start a new chunk and prefix their section's text.

Counterpart of ``pathway_tpu/xpacks/llm/_layout.py``: the same host code over the port's engine.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.xpacks.llm._pdf import (
    _ARR_STR,
    _BT_ET,
    _LIT,
    _STREAM,
    _hex_text,
    _unescape,
)

_NUM = rb"[-+]?(?:\d+\.?\d*|\.\d+)"
#: positioned-text tokenizer: operands captured with their operators
_TOK = re.compile(
    rb"(?P<tm>(?:" + _NUM + rb"\s+){6})Tm"
    rb"|(?P<td>(?:" + _NUM + rb"\s+){2})(?P<tdop>Td|TD)"
    rb"|(?P<tl>" + _NUM + rb")\s+TL"
    rb"|/(?P<font>\S+)\s+(?P<fsize>" + _NUM + rb")\s+Tf"
    rb"|(?P<tstar>T\*)"
    rb"|\((?P<lit>" + _LIT + rb")\)\s*(?P<lop>Tj|'|\")"
    rb"|\[(?P<arr>(?:\(" + _LIT + rb"\)|<[0-9A-Fa-f\s]*>|[^\]()<>])*)\]\s*TJ"
    rb"|<(?P<hex>[0-9A-Fa-f\s]*)>\s*(?P<hop>Tj|'|\")",
    re.DOTALL,
)


@dataclass
class PdfSpan:
    """One shown string and where it was shown."""

    x: float
    y: float
    size: float
    text: str


@dataclass
class LayoutNode:
    """A structural unit: heading, paragraph-ish text block, or table
    (openparse ``Node`` counterpart with ``bbox``/``variant``)."""

    kind: str  # "heading" | "text" | "table"
    text: str
    page: int
    bbox: tuple[float, float, float, float]  # x0, y0, x1, y1


def extract_pdf_spans(data: bytes) -> list[list[PdfSpan]]:
    """Positioned spans per page (content streams with text, in file
    order, like :func:`_pdf.extract_pdf_text`)."""
    if not data.lstrip().startswith(b"%PDF"):
        raise ValueError("not a PDF document (missing %PDF header)")
    pages: list[list[PdfSpan]] = []
    for m in _STREAM.finditer(data):
        raw = m.group(1)
        try:
            content = zlib.decompress(raw)
        except zlib.error:
            content = raw
        spans: list[PdfSpan] = []
        for block in _BT_ET.findall(content):
            spans.extend(_block_spans(block))
        if spans:
            pages.append(spans)
    return pages


def _block_spans(block: bytes) -> list[PdfSpan]:
    # text state per BT block (PDF 32000-1:2008 §9.4)
    x = y = 0.0
    lx = ly = 0.0  # line matrix origin (Td moves relative to it)
    size = 12.0
    scale = 1.0  # vertical scale from Tm's d component
    leading = 14.0
    out: list[PdfSpan] = []

    def show(text: str) -> None:
        if text:
            out.append(PdfSpan(x, y, size * scale, text))

    for m in _TOK.finditer(block):
        if m.group("tm") is not None:
            a, b, c, d, e, f = (float(v) for v in m.group("tm").split())
            lx = x = e
            ly = y = f
            scale = abs(d) or 1.0
        elif m.group("td") is not None:
            tx, ty = (float(v) for v in m.group("td").split())
            if m.group("tdop") == b"TD":
                leading = -ty if ty else leading
            lx = x = lx + tx
            ly = y = ly + ty
        elif m.group("tl") is not None:
            leading = float(m.group("tl"))
        elif m.group("fsize") is not None:
            size = float(m.group("fsize"))
        elif m.group("tstar") is not None:
            ly = y = ly - leading
            x = lx
        elif m.group("lit") is not None:
            if m.group("lop") in (b"'", b'"'):
                # ' and " move to the next line FIRST, then show
                # (ISO 32000-1 §9.4.3)
                ly = y = ly - leading
                x = lx
            show(_unescape(m.group("lit")))
        elif m.group("arr") is not None:
            parts = []
            for s in _ARR_STR.finditer(m.group("arr")):
                if s.group("lit") is not None:
                    parts.append(_unescape(s.group("lit")))
                else:
                    parts.append(_hex_text(s.group("hex")))
            show("".join(parts))
        elif m.group("hex") is not None:
            if m.group("hop") in (b"'", b'"'):
                ly = y = ly - leading
                x = lx
            show(_hex_text(m.group("hex")))
    return out


@dataclass
class _Line:
    y: float
    size: float
    spans: list[PdfSpan] = field(default_factory=list)

    @property
    def x0(self) -> float:
        return min(s.x for s in self.spans)

    @property
    def x1(self) -> float:
        # span width estimate: ~0.5em per char (no font metrics without
        # the font program; adequate for column/table geometry)
        last = max(self.spans, key=lambda s: s.x)
        return last.x + 0.5 * last.size * len(last.text)

    @property
    def text(self) -> str:
        return " ".join(
            s.text.strip() for s in sorted(self.spans, key=lambda s: s.x)
        ).strip()


def _group_lines(spans: list[PdfSpan]) -> list[_Line]:
    lines: list[_Line] = []
    for s in sorted(spans, key=lambda s: (-s.y, s.x)):
        for line in lines:
            if abs(line.y - s.y) <= max(2.0, 0.4 * max(line.size, s.size)):
                line.spans.append(s)
                line.size = max(line.size, s.size)
                break
        else:
            lines.append(_Line(y=s.y, size=s.size, spans=[s]))
    lines.sort(key=lambda ln: -ln.y)
    return lines


def _span_x1(s: PdfSpan) -> float:
    # ~0.5em per char (no font metrics without the font program;
    # adequate for column/table geometry)
    return s.x + 0.5 * s.size * len(s.text)


def _split_columns(spans: list[PdfSpan]) -> list[list[PdfSpan]]:
    """Cluster SPANS into columns before any line grouping — two columns
    share baselines, so grouping lines page-wide would weld them into
    one interleaved line.  A vertical gutter (almost no span crosses it)
    splits the page; reading order is the left column first.  A
    full-width title stays with the left/reading-first column."""
    if len(spans) < 6:
        return [spans]
    starts = sorted({s.x for s in spans})
    best_gap, split_at = 0.0, None
    for a, b in zip(starts, starts[1:]):
        if b - a > best_gap:
            best_gap, split_at = b - a, (a + b) / 2.0
    page_w = max(_span_x1(s) for s in spans) - min(s.x for s in spans)
    if split_at is None or best_gap < 0.25 * max(page_w, 1.0):
        return [spans]
    left = [s for s in spans if s.x < split_at]
    right = [s for s in spans if s.x >= split_at]
    crossers = sum(1 for s in left if _span_x1(s) > split_at + 0.1 * page_w)
    if not left or not right or crossers > max(1, len(left) // 4):
        return [spans]
    return [left, right]


def _detect_tables(lines: list[_Line]) -> list[tuple[int, int]]:
    """(start, end) line-index ranges forming tables: runs of >=2 lines
    with >=2 cells whose x positions align within a tolerance."""
    def cell_xs(line: _Line) -> list[float]:
        return sorted(s.x for s in line.spans)

    ranges: list[tuple[int, int]] = []
    i = 0
    while i < len(lines):
        xs = cell_xs(lines[i])
        if len(xs) < 2:
            i += 1
            continue
        j = i + 1
        while j < len(lines):
            xs2 = cell_xs(lines[j])
            if len(xs2) != len(xs):
                break
            tol = max(3.0, 0.5 * lines[j].size)
            if any(abs(a - b) > tol for a, b in zip(xs, xs2)):
                break
            j += 1
        if j - i >= 2:
            ranges.append((i, j))
            i = j
        else:
            i += 1
    return ranges


def pdf_layout_nodes(data: bytes) -> list[LayoutNode]:
    """Structural nodes in reading order across all pages."""
    nodes: list[LayoutNode] = []
    for page_no, spans in enumerate(extract_pdf_spans(data)):
        sizes = sorted(s.size for s in spans)
        median = sizes[len(sizes) // 2] if sizes else 12.0
        for col_spans in _split_columns(spans):
            column = _group_lines(col_spans)
            tables = _detect_tables(column)
            i = 0
            while i < len(column):
                t = next((t for t in tables if t[0] == i), None)
                if t is not None:
                    rows = column[t[0] : t[1]]
                    text = "\n".join(
                        " | ".join(
                            s.text.strip()
                            for s in sorted(r.spans, key=lambda s: s.x)
                        )
                        for r in rows
                    )
                    nodes.append(
                        LayoutNode(
                            "table",
                            text,
                            page_no,
                            _bbox(rows),
                        )
                    )
                    i = t[1]
                    continue
                line = column[i]
                kind = (
                    "heading"
                    if line.size >= 1.15 * median and line.text
                    else "text"
                )
                if line.text:
                    nodes.append(
                        LayoutNode(kind, line.text, page_no, _bbox([line]))
                    )
                i += 1
    return _merge_text_runs(nodes)


def _bbox(lines: list[_Line]) -> tuple[float, float, float, float]:
    return (
        min(ln.x0 for ln in lines),
        min(ln.y - ln.size for ln in lines),
        max(ln.x1 for ln in lines),
        max(ln.y for ln in lines),
    )


def _merge_text_runs(nodes: list[LayoutNode]) -> list[LayoutNode]:
    """Adjacent text lines on the same page merge into paragraphs-ish
    blocks; headings and tables stay their own nodes."""
    out: list[LayoutNode] = []
    for node in nodes:
        if (
            node.kind == "text"
            and out
            and out[-1].kind == "text"
            and out[-1].page == node.page
        ):
            prev = out[-1]
            out[-1] = LayoutNode(
                "text",
                prev.text + "\n" + node.text,
                node.page,
                (
                    min(prev.bbox[0], node.bbox[0]),
                    min(prev.bbox[1], node.bbox[1]),
                    max(prev.bbox[2], node.bbox[2]),
                    max(prev.bbox[3], node.bbox[3]),
                ),
            )
        else:
            out.append(node)
    return out


def chunk_pdf_layout(
    data: bytes, *, max_chars: int = 1500
) -> list[tuple[str, dict[str, Any]]]:
    """Layout-aware chunks: ``(text, metadata)`` pairs where metadata
    carries page, merged bbox, node kinds, and the governing heading.
    Headings open a new chunk; tables are never split (an oversized
    table is its own chunk, cells intact)."""
    nodes = pdf_layout_nodes(data)
    chunks: list[tuple[str, dict[str, Any]]] = []
    cur: list[LayoutNode] = []
    cur_heading: str | None = None

    def flush() -> None:
        nonlocal cur
        if not cur:
            return
        text = "\n".join(n.text for n in cur)
        meta = {
            "page": cur[0].page,
            "bbox": [
                min(n.bbox[0] for n in cur),
                min(n.bbox[1] for n in cur),
                max(n.bbox[2] for n in cur),
                max(n.bbox[3] for n in cur),
            ],
            "kinds": [n.kind for n in cur],
            "heading": cur_heading,
            "tables": [n.text for n in cur if n.kind == "table"],
        }
        chunks.append((text, meta))
        cur = []

    size = 0
    for node in nodes:
        if node.kind == "heading":
            flush()
            cur_heading = node.text
            cur = [node]
            size = len(node.text)
            continue
        if size + len(node.text) > max_chars and cur:
            flush()
            size = 0
        cur.append(node)
        size += len(node.text)
        if node.kind == "table" and size > max_chars:
            flush()  # oversized table: own chunk, never split
            size = 0
    flush()
    return chunks
