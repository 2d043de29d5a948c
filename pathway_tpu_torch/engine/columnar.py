"""Columnar epoch batches: the Python-side handle for native frames.

A :class:`ColumnarBatch` is an ordered list of *segments*, each either a
native frame capsule (``("f", capsule)`` — contiguous typed columns with
an interned string pool, built by ``native.frame_parse_jsonl`` or
``native.frame_from_updates``) or a plain row list (``("r", [Update])``).
It quacks like the row list the engine has always passed between
operators — ``len``, truthiness, iteration — so every operator that does
not understand frames can call :meth:`to_list` (or just iterate) and run
its existing row-at-a-time path, while frame-aware operators
(``InputNode``, ``GroupByNode``, the exchange router) consume the frame
segments with one native kernel call per segment.

The representation mirrors the reference engine's batched arrangements
(Rust differential ships (data, time, diff) *batches* between operators,
never per-row boxed values); the row-list fallback is this
reproduction's Python-UDF escape hatch.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Iterator

from pathway_tpu_torch.internals import native as _native


def columnar_enabled() -> bool:
    """Global gate: ``PATHWAY_DISABLE_COLUMNAR=1`` forces every operator
    onto the row path (the bench harness uses it for the columnar-vs-row
    smoke gate; also the escape hatch if a frame kernel misbehaves)."""
    return os.environ.get("PATHWAY_DISABLE_COLUMNAR", "") != "1" and (
        _native.load() is not None
    )


class ColumnarBatch:
    """Epoch delta as a sequence of frame/row segments (order preserved:
    iteration yields updates in exactly the order a pure row pipeline
    would have produced them)."""

    __slots__ = ("segments",)

    def __init__(self, segments: list[tuple[str, Any]] | None = None):
        self.segments: list[tuple[str, Any]] = (
            segments if segments is not None else []
        )

    # -- construction ---------------------------------------------------

    @classmethod
    def from_rows(cls, rows: list) -> "ColumnarBatch":
        return cls([("r", rows)] if rows else [])

    def append_frame(self, cap: Any) -> None:
        native = _native.load()
        if native.frame_len(cap):
            self.segments.append(("f", cap))

    def append(self, u: Any) -> None:
        self._tail_rows().append(u)

    def extend(self, rows: Iterable[Any]) -> None:
        if isinstance(rows, ColumnarBatch):
            # merge adjacent row segments so a frame/row/frame interleave
            # does not fragment into many tiny lists
            for kind, seg in rows.segments:
                if kind == "r":
                    self._tail_rows().extend(seg)
                else:
                    self.segments.append((kind, seg))
            return
        rows = list(rows)
        if rows:
            self._tail_rows().extend(rows)

    def _tail_rows(self) -> list:
        if self.segments and self.segments[-1][0] == "r":
            return self.segments[-1][1]
        rows: list = []
        self.segments.append(("r", rows))
        return rows

    # -- row-list protocol ----------------------------------------------

    def __len__(self) -> int:
        native = _native.load()
        n = 0
        for kind, seg in self.segments:
            n += native.frame_len(seg) if kind == "f" else len(seg)
        return n

    def __bool__(self) -> bool:
        # frame segments are non-empty by construction (append_frame
        # drops empties), so any frame segment means data
        return any(
            kind == "f" or bool(seg) for kind, seg in self.segments
        )

    def __iter__(self) -> Iterator[Any]:
        native = _native.load()
        for kind, seg in self.segments:
            if kind == "f":
                yield from native.frame_to_updates(seg)
            else:
                yield from seg

    def to_list(self) -> list:
        """Materialize every segment into one flat Update list — the
        row-path fallback.  Each call builds fresh rows (frames are
        immutable; no caching, so no aliasing between consumers)."""
        native = _native.load()
        out: list = []
        for kind, seg in self.segments:
            if kind == "f":
                out.extend(native.frame_to_updates(seg))
            else:
                out.extend(seg)
        return out

    # -- engine helpers -------------------------------------------------

    def frame_rows(self) -> int:
        """Rows held in frame segments (the columnar-path telemetry)."""
        native = _native.load()
        return sum(
            native.frame_len(seg)
            for kind, seg in self.segments
            if kind == "f"
        )

    def all_plus(self) -> bool:
        """True iff every update in the batch has diff +1 (frame header
        flag for frame segments, a scan for row segments)."""
        native = _native.load()
        for kind, seg in self.segments:
            if kind == "f":
                if not native.frame_all_plus(seg):
                    return False
            elif not native.all_positive(seg):
                return False
        return True

    def split(self, n: int) -> "tuple[ColumnarBatch, ColumnarBatch]":
        """(first n updates, rest) — the epoch row-budget split.  Frame
        segments split by ``frame_slice`` (string pool shared, keys stay
        lazy), so a budget cut through a million-row frame costs two
        column copies, not a materialization."""
        native = _native.load()
        head = ColumnarBatch()
        tail = ColumnarBatch()
        left = n
        for kind, seg in self.segments:
            if left <= 0:
                tail.segments.append((kind, seg))
                continue
            size = native.frame_len(seg) if kind == "f" else len(seg)
            if size <= left:
                head.segments.append((kind, seg))
                left -= size
            elif kind == "f":
                head.append_frame(native.frame_slice(seg, 0, left))
                tail.append_frame(native.frame_slice(seg, left, size))
                left = 0
            else:
                head.segments.append(("r", seg[:left]))
                tail.segments.append(("r", seg[left:]))
                left = 0
        return head, tail


def extend_batch(buf: Any, more: Any) -> Any:
    """Append ``more`` (rows or ColumnarBatch) onto ``buf`` (list or
    ColumnarBatch), promoting the buffer to columnar when frame data
    arrives; returns the (possibly new) buffer.  The single seam through
    which the scheduler's buffers, fan-out, and exchange merges stay
    frame-preserving."""
    if isinstance(more, ColumnarBatch):
        if not isinstance(buf, ColumnarBatch):
            buf = ColumnarBatch.from_rows(buf)
        buf.extend(more)
        return buf
    if isinstance(buf, ColumnarBatch):
        buf.extend(more)
        return buf
    buf.extend(more)
    return buf
