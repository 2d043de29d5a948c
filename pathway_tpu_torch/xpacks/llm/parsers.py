"""Document parsers: bytes -> list[(text, metadata)] UDFs
(reference ``xpacks/llm/parsers.py``; counterpart of
``pathway_tpu/xpacks/llm/parsers.py``).

``ParseUtf8`` is the always-available core.  The rich-document parsers
use ``unstructured`` / ``pypdf`` where they are installed and otherwise
the built-in extractors (``_pdf``, ``_doc``, ``_layout``: the standard
library only); the vision parsers take an ``llm`` chat UDF or a
``parse_fn``.  All of it is host code: nothing here touches a tensor.
"""

from __future__ import annotations

import re
from typing import Any, Callable

from pathway_tpu_torch.internals.udfs import UDF

__all__ = [
    "ParseUtf8",
    "Utf8Parser",
    "ParseUnstructured",
    "UnstructuredParser",
    "ParseHtml",
    "ParseDocx",
    "PypdfParser",
    "ImageParser",
    "SlideParser",
    "OpenParse",
]


class ParseUtf8(UDF):
    """Decode bytes/str to one UTF-8 text chunk (reference
    ``parsers.py:53``)."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        if isinstance(contents, bytes):
            text = contents.decode("utf-8", errors="replace")
        else:
            text = str(contents)
        return [(text, {})]


Utf8Parser = ParseUtf8


class _GatedParser(UDF):
    _pkg = ""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__()
        try:
            __import__(self._pkg)
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} requires the optional {self._pkg!r} "
                "package; ParseUtf8 is always available"
            ) from e
        self._args = args
        self._kwargs = kwargs


class ParseUnstructured(UDF):
    """Auto-format document partitioner (reference ``parsers.py:79``).

    Uses the ``unstructured`` package when installed; otherwise falls
    back to the built-in extractors (content-sniffed): PDF via
    ``_pdf.extract_pdf_text``, DOCX and HTML via ``_doc`` (stdlib
    zipfile/xml/html.parser — no dependencies), anything else UTF-8.
    ``mode="single"`` joins everything into one chunk; ``"elements"``
    yields one chunk per block with ``category`` metadata (Title /
    NarrativeText / ListItem / Table, the unstructured vocabulary);
    ``"paged"`` joins per page (PDF) or per document (other formats).
    """

    def __init__(self, mode: str = "single", **kwargs: Any):
        super().__init__()
        if mode not in ("single", "elements", "paged"):
            raise ValueError(f"invalid mode {mode!r}")
        self.mode = mode
        self._kwargs = kwargs

    def _partition_builtin(self, contents: bytes) -> list[tuple[str, dict]]:
        from pathway_tpu_torch.xpacks.llm import _doc

        fmt = _doc.sniff_format(contents)
        if fmt == "pdf":
            from pathway_tpu_torch.xpacks.llm._pdf import extract_pdf_text

            return [
                (t, {"category": "NarrativeText", "page_number": i})
                for i, t in enumerate(extract_pdf_text(contents))
                if t.strip()
            ]
        if fmt == "docx":
            return _doc.extract_docx_blocks(contents)
        if fmt == "html":
            return _doc.extract_html_blocks(contents)
        text = contents.decode("utf-8", errors="replace")
        return [(text, {"category": "NarrativeText"})] if text.strip() else []

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        if isinstance(contents, str):
            contents = contents.encode()
        try:
            import io

            from unstructured.partition.auto import partition

            elements: list[tuple[str, dict]] = []
            for e in partition(file=io.BytesIO(contents)):
                emeta = getattr(e, "metadata", None)
                meta = {"category": getattr(e, "category", None)}
                page = getattr(emeta, "page_number", None)
                if page is not None:  # paged mode groups by this
                    meta["page_number"] = page
                elements.append((str(e), meta))
        except ImportError:
            elements = self._partition_builtin(contents)
        if self.mode == "elements":
            return elements
        if self.mode == "paged":
            pages: dict[Any, list[str]] = {}
            for text, meta in elements:
                pages.setdefault(meta.get("page_number", 0), []).append(text)
            return [
                ("\n\n".join(parts), {"page_number": pg})
                for pg, parts in sorted(pages.items())
            ]
        return [("\n\n".join(t for t, _ in elements), {})] if elements else []


UnstructuredParser = ParseUnstructured


class ParseHtml(UDF):
    """Built-in HTML parser: block elements with category metadata
    (``_doc.extract_html_blocks``); ``mode="single"`` joins blocks."""

    def __init__(self, mode: str = "single", **kwargs: Any):
        super().__init__()
        if mode not in ("single", "elements"):
            raise ValueError(f"invalid mode {mode!r}")
        self.mode = mode

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        from pathway_tpu_torch.xpacks.llm._doc import extract_html_blocks

        blocks = extract_html_blocks(contents)
        if self.mode == "elements":
            return blocks
        return [("\n\n".join(t for t, _ in blocks), {})] if blocks else []


class ParseDocx(UDF):
    """Built-in DOCX parser: WordprocessingML paragraphs/tables with
    category metadata (``_doc.extract_docx_blocks``)."""

    def __init__(self, mode: str = "single", **kwargs: Any):
        super().__init__()
        if mode not in ("single", "elements"):
            raise ValueError(f"invalid mode {mode!r}")
        self.mode = mode

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        from pathway_tpu_torch.xpacks.llm._doc import extract_docx_blocks

        blocks = extract_docx_blocks(contents)
        if self.mode == "elements":
            return blocks
        return [("\n\n".join(t for t, _ in blocks), {})] if blocks else []


class PypdfParser(UDF):
    """PDF-to-text parser (reference ``parsers.py:746``).  Uses ``pypdf``
    when installed; otherwise falls back to the built-in extractor
    (``_pdf.extract_pdf_text``: FlateDecode streams + BT/ET text
    operators), which covers ordinary text PDFs without any dependency."""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs: Any):
        super().__init__()
        self.apply_text_cleanup = apply_text_cleanup

    @staticmethod
    def _cleanup(text: str) -> str:
        text = re.sub(r"[ \t]+", " ", text)
        return "\n".join(ln.strip() for ln in text.splitlines()).strip()

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        try:
            from pypdf import PdfReader  # only the import probes: errors
        except ImportError:  # raised INSIDE pypdf later must surface
            PdfReader = None
        if PdfReader is not None:
            import io

            pages = [
                page.extract_text() or ""
                for page in PdfReader(io.BytesIO(contents)).pages
            ]
        else:
            from pathway_tpu_torch.xpacks.llm._pdf import extract_pdf_text

            pages = extract_pdf_text(contents)
        if self.apply_text_cleanup:
            pages = [self._cleanup(p) for p in pages]
        return [(p, {"page": i}) for i, p in enumerate(pages) if p]


class ImageParser(UDF):
    """Vision-LLM image description parser (reference ``parsers.py:396``);
    requires a multimodal ``llm`` chat UDF."""

    def __init__(
        self,
        llm: Any = None,
        parse_prompt: str = "Describe the image contents.",
        parse_fn: Callable | None = None,
        **kwargs: Any,
    ):
        super().__init__()
        self.llm = llm
        self.parse_prompt = parse_prompt
        self.parse_fn = parse_fn

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        if self.parse_fn is not None:
            return [(str(self.parse_fn(contents)), {})]
        if self.llm is None:
            raise ValueError("ImageParser needs an llm or a parse_fn")
        import base64

        b64 = base64.b64encode(contents).decode()
        text = self.llm.__wrapped__(
            [
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": self.parse_prompt},
                        {
                            "type": "image_url",
                            "image_url": {"url": f"data:image/png;base64,{b64}"},
                        },
                    ],
                }
            ]
        )
        return [(str(text), {})]


class SlideParser(ImageParser):
    """Slide-deck vision parser (reference ``parsers.py:569``,
    license-gated there; here simply ImageParser over rendered pages)."""


class OpenParse(UDF):
    """Layout-aware PDF chunking (reference ``parsers.py:235`` wrapping
    the ``openparse`` package + ``openparse_utils.py``: bbox-positioned
    nodes, heading/table detection, chunk merging).

    Backed by the built-in layout engine in ``_layout.py`` — spans from
    the PDF text matrix, column splitting, font-size heading detection,
    x-aligned-run table detection with ``" | "`` cell separators, and
    bbox-merged chunks where headings open a section and tables are
    never split.  ``table_args={"parsing_algorithm": "llm"}`` (the
    reference's vision-LLM table path) additionally runs ``llm`` over
    each detected table's text to reshape it.

    Args:
        max_chars: chunk budget (a table larger than this still stays
            one chunk — cells are never split).
        table_args: ``{"parsing_algorithm": "native" | "llm"}``;
            "native" (default) emits detected tables as pipe-separated
            rows; "llm" requires ``llm=``.
        llm: chat UDF used when ``parsing_algorithm == "llm"``.
    """

    def __init__(
        self,
        *,
        max_chars: int = 1500,
        table_args: dict | None = None,
        llm: Any = None,
        **kwargs: Any,
    ):
        super().__init__()
        self.max_chars = max_chars
        self.table_args = table_args or {"parsing_algorithm": "native"}
        algorithm = self.table_args.get("parsing_algorithm", "native")
        if algorithm not in ("native", "llm"):
            raise ValueError(
                f"unknown table parsing_algorithm {algorithm!r}"
            )
        if algorithm == "llm" and llm is None:
            raise ValueError("parsing_algorithm='llm' requires llm=...")
        self.llm = llm

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        from pathway_tpu_torch.xpacks.llm._layout import chunk_pdf_layout

        chunks = chunk_pdf_layout(contents, max_chars=self.max_chars)
        if self.table_args.get("parsing_algorithm") == "llm":
            # rewrite ONLY each detected table's rows in place — the
            # surrounding prose of a mixed chunk must pass through
            # untouched
            out = []
            for text, meta in chunks:
                for table_text in meta.get("tables", ()):
                    rewritten = str(
                        self.llm.__wrapped__(
                            [
                                {
                                    "role": "user",
                                    "content": (
                                        "Rewrite this extracted table as "
                                        "clean markdown, preserving every "
                                        "cell:\n" + table_text
                                    ),
                                }
                            ]
                        )
                    )
                    text = text.replace(table_text, rewritten)
                out.append((text, meta))
            return out
        return chunks


#: parsers of ``pathway_tpu.xpacks.llm.parsers`` that a later slice brings
#: (none: every parser of the JAX module is ported)
_LATER: tuple[str, ...] = ()
