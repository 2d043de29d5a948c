"""Low-overhead distributed tracing with an always-on flight recorder.

Every span is one tuple appended into a **per-thread fixed-size ring
buffer** — the record path is a tuple build plus a list-slot assignment
and an index increment, with **no locks, no allocation beyond the tuple,
no syscalls** (``scripts/check_locks.py`` lints this file; the LK007
whole-repo lock graph must stay cycle-free and the only lock here is the
leaf-level ring registry mutex, taken once per thread at ring creation
and on the dump path — never per record).

Record layout (one tuple per span)::

    (trace_id, span_id, parent_id, stage, rank, t0_ns, t1_ns, sampled, args)

``t0_ns``/``t1_ns`` are ``time.monotonic_ns()`` — on Linux
CLOCK_MONOTONIC is machine-wide, so spans recorded by *different
processes on one host* share a timebase and stitch into one causal
timeline without clock translation (the 2-proc chaos drills rely on
this).

Sampling: the ring is **always on** (that is what makes it a flight
recorder — the last ``ring_size`` spans per thread are always there for
a post-mortem dump), so head sampling governs *export*, not recording:

- ``PATHWAY_TRACE_SAMPLE`` (0..1, default 1.0) — fraction of new traces
  marked ``sampled``; only sampled traces appear in on-demand exports
  (``/debug/trace``, ``chrome_events()``) unless ``all_spans=True``.
- ``PATHWAY_TRACE_TAIL_MS`` (default 250) — a request whose end-to-end
  latency exceeds this is **always kept**: :func:`finish_request` adds
  its trace id to a bounded tail-keep ring, resurrecting the trace in
  exports even when head sampling skipped it.  Slow requests are the
  ones worth attributing; the knob guarantees they survive sampling.

Other knobs: ``PATHWAY_TRACE=0`` disables recording entirely (the
bench overhead gate A/Bs this), ``PATHWAY_TRACE_RING`` sizes the
per-thread ring (default 4096 spans), and ``PATHWAY_TRACE_DIR`` names
the flight-recorder spool: when set, :func:`flush` writes
``trace-r{rank}-*.json`` Chrome-trace files there (and an atexit hook
flushes on clean process exit).  Dump triggers wired elsewhere:
liveness trips (``engine/cluster.py`` ``_fail``/``_fail_peer``), chaos
kills (``testing/chaos.py`` flushes before ``os._exit``), supervisor
restarts (``internals/resilience.py`` merges the per-rank spool into
``merged_trace.json``), SIGUSR2 (:func:`install_sigusr2` — also dumps
all Python thread stacks), and ``/debug/trace?seconds=N`` on the
monitoring server.

Context propagation is ambient: :func:`use` pins a
:class:`TraceContext` to the current thread, :func:`span` opens a child
span under it (re-parenting nested spans), and the serving/cluster
layers carry contexts across thread and process hops explicitly —
serving requests on the request object, cluster epochs piggybacked on
the round-status exchange frames (``Cluster.round_statuses``).
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
import traceback
from typing import Any, Callable, Iterator

__all__ = [
    "TraceContext",
    "chrome_events",
    "configure",
    "current",
    "current_rank",
    "dump",
    "dump_stacks",
    "enabled",
    "finish_request",
    "flush",
    "install_sigusr2",
    "merge_trace_dir",
    "new_trace",
    "now_ns",
    "record_span",
    "record_spans",
    "reset",
    "set_ambient",
    "set_rank",
    "span",
    "use",
]

_monotonic_ns = time.monotonic_ns

#: the span clock (machine-wide monotonic, so spans from different
#: processes on one host line up without translation)
now_ns = time.monotonic_ns

#: tail-keep ring capacity (trace ids of slow requests kept past sampling)
_KEPT_CAP = 4096


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class _Config:
    __slots__ = ("on", "sample", "tail_ns", "ring_size", "spool_dir")

    def __init__(self) -> None:
        self.reload()

    def reload(self) -> None:
        self.on = os.environ.get("PATHWAY_TRACE", "1") != "0"
        self.sample = min(1.0, max(0.0, _env_float("PATHWAY_TRACE_SAMPLE", 1.0)))
        self.tail_ns = int(_env_float("PATHWAY_TRACE_TAIL_MS", 250.0) * 1e6)
        self.ring_size = max(64, _env_int("PATHWAY_TRACE_RING", 4096))
        self.spool_dir = os.environ.get("PATHWAY_TRACE_DIR") or None


_cfg = _Config()

#: process rank stamped into every span (supervised workers inherit it
#: from the spawn env; in-process tests may override via set_rank)
_rank = _env_int("PATHWAY_PROCESS_ID", 0)

#: leaf lock: ring registration + dump/flush serialization only — NEVER
#: on the record path, and nothing is acquired while it is held
_registry_mutex = threading.Lock()
_rings: list["_Ring"] = []

#: bounded tail-keep ring: trace ids of requests over the tail threshold
#: (preallocated; racy slot assignment loses at most one id — benign)
_kept: list[int] = [0] * _KEPT_CAP
_kept_idx = 0

_atexit_installed = False


class _Ring:
    """One thread's span ring: preallocated slots, lock-free append."""

    __slots__ = ("buf", "idx", "cap", "thread_name", "id_next")

    def __init__(self, cap: int, thread_name: str, id_seed: int):
        self.cap = cap
        self.buf: list[Any] = [None] * cap
        self.idx = 0
        self.thread_name = thread_name
        self.id_next = id_seed

    def snapshot(self) -> list[tuple]:
        """Copy the live records in append order (dump path; the copy is
        a single C-level list() under the GIL, racing appends at worst
        tear the oldest slot, which is dropped by the None filter)."""
        buf = list(self.buf)
        i = self.idx
        if i <= self.cap:
            out = buf[:i]
        else:
            head = i % self.cap
            out = buf[head:] + buf[:head]
        return [r for r in out if r is not None]


class _Tls(threading.local):
    ring: "_Ring | None" = None
    ctx: "TraceContext | None" = None


_tls = _Tls()


def _make_ring() -> _Ring:
    t = threading.current_thread()
    # seeded per ring so span ids are unique across threads/processes
    # without coordination: high bits random, low bits a local counter
    seed = (random.getrandbits(30) << 33) | (os.getpid() & 0xFFFF) << 17
    ring = _Ring(_cfg.ring_size, t.name, seed)
    with _registry_mutex:
        _rings.append(ring)
    _tls.ring = ring
    global _atexit_installed
    if _cfg.spool_dir and not _atexit_installed:
        _atexit_installed = True
        import atexit

        atexit.register(lambda: flush("exit"))
    return ring


class TraceContext:
    """One request's (or epoch's) propagated identity: which trace the
    next span belongs to and which span is its parent."""

    __slots__ = ("trace_id", "span_id", "sampled", "t0_ns")

    def __init__(self, trace_id: int, span_id: int = 0, sampled: bool = True,
                 t0_ns: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.t0_ns = t0_ns

    def child(self, span_id: int) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.sampled, self.t0_ns)

    def to_wire(self) -> tuple[int, int, bool]:
        """Compact form piggybacked on cluster exchange frames."""
        return (self.trace_id, self.span_id, self.sampled)

    @staticmethod
    def from_wire(wire: Any) -> "TraceContext | None":
        try:
            trace_id, span_id, sampled = wire
            return TraceContext(int(trace_id), int(span_id), bool(sampled))
        except (TypeError, ValueError):
            return None


# ----------------------------------------------------------------- config


def configure(**env: Any) -> None:
    """Apply env-style knobs programmatically and reload the config
    (tests and bench use this instead of mutating os.environ ad hoc)."""
    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    _cfg.reload()


def enabled() -> bool:
    return _cfg.on


def set_rank(rank: int) -> None:
    global _rank
    _rank = int(rank)


def current_rank() -> int:
    return _rank


def reset() -> None:
    """Drop every registered ring and tail-keep entry (test isolation)."""
    global _kept_idx
    with _registry_mutex:
        _rings.clear()
    _tls.ring = None
    _tls.ctx = None
    for i in range(_KEPT_CAP):
        _kept[i] = 0
    _kept_idx = 0
    _cfg.reload()


# ------------------------------------------------------------ record path


def _next_id() -> int:
    ring = _tls.ring
    if ring is None:
        ring = _make_ring()
    ring.id_next += 1
    return ring.id_next


def new_trace(sampled: bool | None = None) -> TraceContext:
    """Open a new trace (one per serving request / epoch).  Draws the
    head-sampling decision unless ``sampled`` is forced."""
    trace_id = _next_id()
    if sampled is None:
        s = _cfg.sample
        sampled = s >= 1.0 or (s > 0.0 and random.random() < s)
    return TraceContext(trace_id, trace_id, sampled, _monotonic_ns())


def current() -> TraceContext | None:
    """The thread's ambient trace context (None outside any request)."""
    return _tls.ctx


class _Use:
    __slots__ = ("ctx", "prev")

    def __init__(self, ctx: TraceContext | None):
        self.ctx = ctx
        self.prev: TraceContext | None = None

    def __enter__(self) -> TraceContext | None:
        self.prev = _tls.ctx
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc: Any) -> None:
        _tls.ctx = self.prev


def use(ctx: TraceContext | None) -> _Use:
    """Pin ``ctx`` as the thread's ambient context for a ``with`` block
    (stage workers adopt the request's context this way)."""
    return _Use(ctx)


def set_ambient(ctx: TraceContext | None) -> TraceContext | None:
    """Swap the thread's ambient context, returning the previous one.
    The try/finally flavor of :func:`use` for per-task hot loops where
    the CM's object + enter/exit dispatch is measurable."""
    tls = _tls
    prev = tls.ctx
    tls.ctx = ctx
    return prev


def record_span(
    stage: str,
    t0_ns: int,
    t1_ns: int,
    ctx: TraceContext | None = None,
    args: dict | None = None,
) -> int:
    """Record one completed span; returns its span id (0 when tracing is
    off).  THE hot path: no locks, no I/O — one tuple into the ring."""
    if not _cfg.on:
        return 0
    tls = _tls
    ring = tls.ring
    if ring is None:
        ring = _make_ring()
    span_id = ring.id_next = ring.id_next + 1
    if ctx is None:
        ctx = tls.ctx
    if ctx is not None:
        rec = (ctx.trace_id, span_id, ctx.span_id, stage, _rank,
               t0_ns, t1_ns, ctx.sampled, args)
    else:
        rec = (0, span_id, 0, stage, _rank, t0_ns, t1_ns, False, args)
    ring.buf[ring.idx % ring.cap] = rec
    ring.idx += 1
    return span_id


def record_spans(
    ctx: TraceContext | None,
    spans: "list[tuple[str, int, int, dict | None]]",
) -> None:
    """Record a batch of completed ``(stage, t0_ns, t1_ns, args)`` spans
    under ``ctx`` in one call.  The serving path stamps raw timestamps as
    a request moves through its stages (it needs them for the latency
    probes anyway) and materializes all spans here at request end —
    one call per request instead of one per stage."""
    if not _cfg.on or ctx is None:
        return
    ring = _tls.ring
    if ring is None:
        ring = _make_ring()
    buf, cap = ring.buf, ring.cap
    i, nid = ring.idx, ring.id_next
    trace_id, parent, sampled = ctx.trace_id, ctx.span_id, ctx.sampled
    rank = _rank
    for stage, t0_ns, t1_ns, args in spans:
        nid += 1
        buf[i % cap] = (trace_id, nid, parent, stage, rank,
                        t0_ns, t1_ns, sampled, args)
        i += 1
    ring.id_next = nid
    ring.idx = i


class _Span:
    """Hot-path span CM.  Doubles as the child TraceContext while the
    block runs (it carries trace_id/span_id/sampled/t0_ns, which is all
    record_span reads), so entering a span allocates no extra object."""

    __slots__ = ("stage", "args", "parent", "t0_ns", "prev",
                 "trace_id", "span_id", "sampled")

    def __init__(self, stage: str, args: dict | None, ctx: TraceContext | None):
        self.stage = stage
        self.args = args
        self.parent = ctx

    def __enter__(self) -> "_Span":
        tls = _tls
        self.prev = tls.ctx
        if not _cfg.on:
            # tracing off: no id, no ambient swap, no clock read; the
            # zero t0 tells __exit__ to skip even if toggled on mid-block
            self.parent = None
            self.t0_ns = 0
            return self
        ctx = self.parent if self.parent is not None else self.prev
        self.parent = ctx
        if ctx is not None:
            # pre-allocate this span's id so children recorded inside the
            # block parent onto it (the record at exit reuses the id)
            ring = tls.ring
            if ring is None:
                ring = _make_ring()
            ring.id_next += 1
            self.trace_id = ctx.trace_id
            self.span_id = ring.id_next
            self.sampled = ctx.sampled
            tls.ctx = self
        self.t0_ns = _monotonic_ns()
        return self

    def __exit__(self, et: Any, ev: Any, tb: Any) -> None:
        tls = _tls
        tls.ctx = self.prev
        if not _cfg.on or self.t0_ns == 0:
            return
        t1 = _monotonic_ns()
        ring = tls.ring
        if ring is None:
            ring = _make_ring()
        parent = self.parent
        if parent is not None:
            rec = (self.trace_id, self.span_id, parent.span_id,
                   self.stage, _rank, self.t0_ns, t1, self.sampled,
                   self.args)
        else:
            ring.id_next += 1
            rec = (0, ring.id_next, 0, self.stage, _rank, self.t0_ns, t1,
                   False, self.args)
        ring.buf[ring.idx % ring.cap] = rec
        ring.idx += 1


def span(stage: str, args: dict | None = None,
         ctx: TraceContext | None = None) -> _Span:
    """Time a ``with`` block as one span under the ambient (or given)
    context; nested ``span()`` calls inside the block parent onto it."""
    return _Span(stage, args, ctx)


def finish_request(ctx: TraceContext | None, t1_ns: int | None = None) -> None:
    """Mark a request finished: if its end-to-end latency crossed the
    tail threshold, keep its trace regardless of head sampling."""
    global _kept_idx
    if ctx is None or not _cfg.on:
        return
    t1 = t1_ns if t1_ns is not None else _monotonic_ns()
    if ctx.t0_ns and (t1 - ctx.t0_ns) >= _cfg.tail_ns:
        i = _kept_idx
        _kept[i % _KEPT_CAP] = ctx.trace_id
        _kept_idx = i + 1


# ------------------------------------------------------------- dump path


def snapshot_records() -> list[tuple]:
    """Every live ring's records, append order per ring."""
    with _registry_mutex:
        rings = list(_rings)
    out: list[tuple] = []
    for ring in rings:
        out.extend(ring.snapshot())
    return out


def _ring_names() -> dict[int, str]:
    with _registry_mutex:
        return {id(r): r.thread_name for r in _rings}


def chrome_events(
    since_ns: int | None = None, all_spans: bool = False
) -> list[dict]:
    """Render the rings as Chrome-trace / Perfetto ``traceEvents``
    (``ph: "X"`` complete events; ``pid`` = rank, ``tid`` = thread).

    Export filter: spans of sampled traces, spans of tail-kept traces,
    and context-free spans (``trace_id == 0`` — flight-recorder noise
    floor) — or everything with ``all_spans=True``."""
    kept = set(_kept) - {0}
    events: list[dict] = []
    with _registry_mutex:
        rings = list(_rings)
    for ring in rings:
        tid = ring.thread_name
        for rec in ring.snapshot():
            trace_id, span_id, parent, stage, rank, t0, t1, sampled, args = rec
            if since_ns is not None and t1 < since_ns:
                continue
            if not all_spans and trace_id and not sampled and trace_id not in kept:
                continue
            ev_args = {"trace_id": trace_id, "span_id": span_id,
                       "parent": parent}
            if args:
                ev_args.update(args)
            events.append({
                "ph": "X",
                "name": stage,
                "cat": "pathway",
                "pid": rank,
                "tid": tid,
                "ts": t0 / 1e3,
                "dur": max(t1 - t0, 0) / 1e3,
                "args": ev_args,
            })
    events.sort(key=lambda e: e["ts"])
    return events


def dump(path: str, *, since_ns: int | None = None,
         all_spans: bool = True) -> str:
    """Write a Chrome-trace JSON file (open it at ui.perfetto.dev or
    chrome://tracing).  Flight-recorder dumps default to ``all_spans``:
    a post-mortem wants everything the ring still holds."""
    doc = {
        "traceEvents": chrome_events(since_ns=since_ns, all_spans=all_spans),
        "displayTimeUnit": "ms",
        "otherData": {"rank": _rank, "pid": os.getpid()},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


_flush_n = 0


def flush(reason: str = "manual") -> str | None:
    """Flight-recorder flush: dump this process's rings into the spool
    dir (``PATHWAY_TRACE_DIR``).  No-op (None) when no spool is set.
    Safe to call from failure paths — never raises."""
    global _flush_n
    spool = _cfg.spool_dir
    if not spool:
        return None
    try:
        os.makedirs(spool, exist_ok=True)
        with _registry_mutex:
            _flush_n += 1
            n = _flush_n
        path = os.path.join(
            spool, f"trace-r{_rank}-p{os.getpid()}-{n:03d}-{reason}.json"
        )
        return dump(path)
    except Exception:  # noqa: BLE001 — a failing dump must not mask the failure
        return None


def merge_trace_dir(spool: str, out_path: str | None = None) -> str | None:
    """Merge every per-rank ``trace-*.json`` in ``spool`` into ONE
    Chrome-trace file (default ``<spool>/merged_trace.json``) — the
    single stitched timeline the chaos drills assert on.  Events keep
    their per-rank ``pid``; duplicate (span_id, rank) pairs from repeat
    flushes of one ring collapse to the last occurrence."""
    try:
        names = sorted(
            f for f in os.listdir(spool)
            if f.startswith("trace-") and f.endswith(".json")
        )
    except OSError:
        return None
    if not names:
        return None
    by_key: dict[Any, dict] = {}
    loose: list[dict] = []
    for name in names:
        try:
            with open(os.path.join(spool, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        for ev in doc.get("traceEvents", ()):
            sid = ev.get("args", {}).get("span_id")
            if sid:
                by_key[(ev.get("pid"), sid)] = ev
            else:
                loose.append(ev)
    events = list(by_key.values()) + loose
    events.sort(key=lambda e: e.get("ts", 0))
    out_path = out_path or os.path.join(spool, "merged_trace.json")
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, out_path)
    return out_path


# --------------------------------------------------- stacks + SIGUSR2


def dump_stacks() -> str:
    """Every Python thread's stack as text (hang diagnosis; served by
    ``/debug/stacks`` and written to stderr on SIGUSR2)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    parts: list[str] = []
    for ident, frame in frames.items():
        name = names.get(ident, "?")
        parts.append(f"--- Thread {name} (ident {ident}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts) + "\n"


_sigusr2_installed = False


def install_sigusr2() -> bool:
    """SIGUSR2 → dump all thread stacks to stderr AND flush the flight
    recorder to the spool dir.  Main-thread only (signal module rule);
    returns False when it cannot install."""
    global _sigusr2_installed
    if _sigusr2_installed:
        return True
    try:
        import signal

        def _handler(_signum: int, _frame: Any) -> None:
            try:
                sys.stderr.write(dump_stacks())
                sys.stderr.flush()
            except Exception:  # noqa: BLE001
                pass
            flush("sigusr2")

        signal.signal(signal.SIGUSR2, _handler)
        _sigusr2_installed = True
        return True
    except (ValueError, OSError, AttributeError):
        return False  # not the main thread, or no SIGUSR2 (non-POSIX)
