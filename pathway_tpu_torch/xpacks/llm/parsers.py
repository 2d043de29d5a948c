"""Document parsers: bytes -> list[(text, metadata)] UDFs
(reference ``xpacks/llm/parsers.py``; counterpart of
``pathway_tpu/xpacks/llm/parsers.py``).

``ParseUtf8`` is the always-available core.  The JAX package's other
parsers (unstructured / HTML / DOCX / PDF / vision-LLM, with their
built-in extractors) come with ROADMAP item 16; until then their names
raise an ``AttributeError`` that says so.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF

__all__ = ["ParseUtf8", "Utf8Parser"]

#: parsers of ``pathway_tpu.xpacks.llm.parsers`` that a later slice brings
_LATER = (
    "ParseUnstructured",
    "UnstructuredParser",
    "ParseHtml",
    "ParseDocx",
    "PypdfParser",
    "ImageParser",
    "SlideParser",
    "OpenParse",
)


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


def __getattr__(name: str) -> Any:
    if name in _LATER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} yet: the port brings it with "
            "ROADMAP item 16 (slice 16e: the other parsers)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
