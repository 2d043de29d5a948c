"""Built-in PDF text extraction (no third-party dependency).

Fallback engine for :class:`~pathway_tpu_torch.xpacks.llm.parsers.PypdfParser`
(reference ``parsers.py:746`` wraps the ``pypdf`` package; this module
implements the subset that covers ordinary text PDFs natively):

- content streams located via ``stream``/``endstream`` framing,
- FlateDecode (zlib) decompression — the compression used by virtually
  every text PDF,
- text extraction from ``BT``/``ET`` blocks: ``Tj``, ``'``, ``"`` and
  ``TJ`` show operators, literal ``(...)`` strings with escape handling,
  and hex ``<...>`` strings,
- ``Td``/``TD``/``T*``/``Tm`` line-advance heuristics for newlines.

Complex encodings (CID/Type0 fonts with ToUnicode CMaps) are out of
scope: those documents need the real ``pypdf`` (used automatically when
installed).

Counterpart of ``pathway_tpu/xpacks/llm/_pdf.py``: the same host code over the port's engine.
"""

from __future__ import annotations

import re
import zlib

_STREAM = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.DOTALL)
_BT_ET = re.compile(rb"BT(.*?)ET", re.DOTALL)
#: literal string body: escapes, plain chars, or ONE level of balanced
#: unescaped parentheses (legal per the PDF spec; deeper nesting is rare)
_LIT = rb"(?:\\.|[^\\()]|\((?:\\.|[^\\()])*\))*"
#: TJ array body: literal strings, hex strings, or non-bracket chars —
#: so a ']' inside a string does not end the array early
_ARR = rb"(?:\(" + _LIT + rb"\)|<[0-9A-Fa-f\s]*>|[^\]()<>])*"
#: one text-showing or line-moving operator inside a BT block
_TEXT_OP = re.compile(
    rb"\((?P<lit>" + _LIT + rb")\)\s*(?P<op>Tj|'|\")"  # (s) Tj / ' / "
    rb"|\[(?P<arr>" + _ARR + rb")\]\s*TJ"  # [(a) -250 (b)] TJ
    rb"|<(?P<hex>[0-9A-Fa-f\s]*)>\s*(?P<hop>Tj|'|\")"
    rb"|(?P<nl>T\*|Td|TD|Tm)",
    re.DOTALL,
)
_ARR_STR = re.compile(
    rb"\((?P<lit>" + _LIT + rb")\)|<(?P<hex>[0-9A-Fa-f\s]*)>"
)

_ESCAPES = {
    b"n": b"\n",
    b"r": b"\r",
    b"t": b"\t",
    b"b": b"\b",
    b"f": b"\f",
    b"(": b"(",
    b")": b")",
    b"\\": b"\\",
}


def _unescape(raw: bytes) -> str:
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < n:
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if b"0" <= nxt <= b"7":  # \ddd octal (1-3 digits, 0-7 only)
                j = i + 1
                while j < min(i + 4, n) and b"0" <= raw[j : j + 1] <= b"7":
                    j += 1
                out.append(int(raw[i + 1 : j], 8) & 0xFF)
                i = j
                continue
            i += 1  # line continuation / unknown escape: drop the backslash
            continue
        out += c
        i += 1
    return out.decode("latin-1")


def _hex_text(h: bytes) -> str:
    h = re.sub(rb"\s", b"", h)
    if len(h) % 2:
        h += b"0"
    data = bytes.fromhex(h.decode("ascii"))
    if len(data) >= 2 and all(b == 0 for b in data[::2]):
        # UTF-16BE-looking two-byte codes (common Identity-H simple case)
        return data.decode("utf-16-be", errors="ignore")
    return data.decode("latin-1")


def _block_text(block: bytes) -> str:
    parts: list[str] = []
    for m in _TEXT_OP.finditer(block):
        if m.group("nl") is not None:
            if parts and not parts[-1].endswith("\n"):
                parts.append("\n")
            continue
        if m.group("lit") is not None:
            parts.append(_unescape(m.group("lit")))
            if m.group("op") in (b"'", b'"'):
                parts.append("\n")
        elif m.group("arr") is not None:
            for s in _ARR_STR.finditer(m.group("arr")):
                if s.group("lit") is not None:
                    parts.append(_unescape(s.group("lit")))
                else:
                    parts.append(_hex_text(s.group("hex")))
        elif m.group("hex") is not None:
            parts.append(_hex_text(m.group("hex")))
            if m.group("hop") in (b"'", b'"'):
                parts.append("\n")
    return "".join(parts)


def extract_pdf_text(data: bytes) -> list[str]:
    """Text of each content stream that contains text operators, in file
    order (approximates page order for ordinary single-stream pages)."""
    if not data.lstrip().startswith(b"%PDF"):
        raise ValueError("not a PDF document (missing %PDF header)")
    pages: list[str] = []
    for m in _STREAM.finditer(data):
        raw = m.group(1)
        try:
            content = zlib.decompress(raw)
        except zlib.error:
            content = raw
        blocks = _BT_ET.findall(content)
        if not blocks:
            continue
        text = "\n".join(filter(None, (_block_text(b).strip() for b in blocks)))
        if text:
            pages.append(text)
    return pages
