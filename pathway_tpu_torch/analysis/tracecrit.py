"""Critical-path reconstruction and stage attribution over trace dumps.

Input is the Chrome-trace JSON the flight recorder emits
(:mod:`pathway_tpu_torch.internals.tracing` — ``ph: "X"`` complete events
whose ``args`` carry ``trace_id``/``span_id``/``parent``).  This module
answers the question the aggregate histograms cannot: *which stage did
THIS slow request actually wait on?*

The model: within one trace, every span's **exclusive time** is its
duration minus the union of its children's intervals — the time the
request spent *in* that span and nowhere deeper.  Summed over a trace,
exclusive times partition the root span's wall time exactly, so the
per-category breakdown of a request always adds up to its end-to-end
latency.  Categories bucket the stage names recorded across the repo:

- ``queue_wait`` — admission + scheduler-lane queueing (``serve_sched``,
  generation-queue wait)
- ``exchange``  — cluster pack/send/unpack + per-peer status waits
- ``device``    — embed / search / generate / epoch compute
- ``merge``     — segment merge + sink/commit work
- ``lock``      — spans explicitly named as lock waits
- ``checkpoint``— snapshot serialization and writes
- ``other``     — everything else (including untraced gaps)

:func:`critical_path` additionally extracts the single deepest-wait
chain: walking from the root, at each level pick the child contributing
the most wall time, yielding the "admission → scheduler → dispatch →
collect" style path reports quote.  :func:`report` rolls per-trace
breakdowns into p50/p99 attribution (the JAX package's ``bench.py``
embeds it in ``BENCH_trace.json``; the port's benchmark is to come).
"""

from __future__ import annotations

import json
from typing import Any, Iterable

__all__ = [
    "CATEGORY_OF",
    "attribute",
    "categorize",
    "connected_traces",
    "critical_path",
    "group_traces",
    "load_events",
    "report",
]

#: stage-name prefix → attribution category (first match wins; checked
#: in declaration order, most specific first)
CATEGORY_OF: tuple[tuple[str, str], ...] = (
    ("credit_wait", "exchange"),
    ("serve_sched", "queue_wait"),
    ("gen_queue", "queue_wait"),
    ("admit", "queue_wait"),
    ("status_wait", "exchange"),
    ("exchange", "exchange"),
    ("allgather", "exchange"),
    ("pack", "exchange"),
    ("unpack", "exchange"),
    ("send", "exchange"),
    ("recv", "exchange"),
    ("checkpoint", "checkpoint"),
    ("snapshot", "checkpoint"),
    ("merge", "merge"),
    ("pre_commit", "merge"),
    ("sink", "merge"),
    ("lock", "lock"),
    ("serve_embed", "device"),
    ("serve_generate", "device"),
    ("serve_retrieve", "device"),
    ("embed", "device"),
    ("generate", "device"),
    ("search", "device"),
    ("dispatch", "device"),
    ("collect", "device"),
    ("epoch", "device"),
    ("process", "device"),
    ("ingest", "device"),
    ("cut", "device"),
)

CATEGORIES = ("queue_wait", "exchange", "device", "merge", "lock",
              "checkpoint", "other")


def categorize(stage: str) -> str:
    for prefix, cat in CATEGORY_OF:
        if stage.startswith(prefix):
            return cat
    return "other"


def load_events(path: str) -> list[dict]:
    """Read one Chrome-trace JSON file's traceEvents."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare event-array form is also legal
        return doc
    return list(doc.get("traceEvents", ()))


def group_traces(events: Iterable[dict]) -> dict[int, list[dict]]:
    """Bucket events by args.trace_id, dropping context-free spans."""
    traces: dict[int, list[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        tid = ev.get("args", {}).get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(ev)
    return traces


def _span_ids(spans: list[dict]) -> dict[int, dict]:
    return {
        s["args"]["span_id"]: s for s in spans if s["args"].get("span_id")
    }


def connected_traces(events: Iterable[dict]) -> dict[int, bool]:
    """For each trace: does every span's parent resolve inside the trace
    (parents equal to the trace id itself are the root hook)?  True means
    the causal chain stitches end to end with no orphaned fragments."""
    out: dict[int, bool] = {}
    for trace_id, spans in group_traces(events).items():
        ids = set(_span_ids(spans))
        ok = True
        for s in spans:
            parent = s["args"].get("parent", 0)
            if parent and parent != trace_id and parent not in ids:
                ok = False
                break
        out[trace_id] = ok
    return out


def _children(spans: list[dict]) -> dict[int, list[dict]]:
    kids: dict[int, list[dict]] = {}
    for s in spans:
        kids.setdefault(s["args"].get("parent", 0), []).append(s)
    for lst in kids.values():
        lst.sort(key=lambda s: s.get("ts", 0.0))
    return kids


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [t0, t1) intervals, in ms (inputs µs)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur0, cur1 = intervals[0]
    for t0, t1 in intervals[1:]:
        if t0 > cur1:
            total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    total += cur1 - cur0
    return total / 1e3


def attribute(spans: list[dict]) -> dict[str, Any]:
    """One trace's breakdown: per-stage and per-category **exclusive**
    milliseconds, plus the trace's wall time (earliest start to latest
    end across all its spans, any rank)."""
    kids = _children(spans)
    by_stage: dict[str, float] = {}
    by_cat: dict[str, float] = {c: 0.0 for c in CATEGORIES}
    for s in spans:
        sid = s["args"].get("span_id")
        dur = float(s.get("dur", 0.0))
        t0 = float(s.get("ts", 0.0))
        covered = _union_ms(
            [
                (max(t0, float(c.get("ts", 0.0))),
                 min(t0 + dur,
                     float(c.get("ts", 0.0)) + float(c.get("dur", 0.0))))
                for c in kids.get(sid, ())
                if float(c.get("ts", 0.0)) < t0 + dur
                and float(c.get("ts", 0.0)) + float(c.get("dur", 0.0)) > t0
            ]
        )
        exclusive = max(dur / 1e3 - covered, 0.0)
        stage = s.get("name", "?")
        by_stage[stage] = by_stage.get(stage, 0.0) + exclusive
        by_cat[categorize(stage)] += exclusive
    t_lo = min(float(s.get("ts", 0.0)) for s in spans)
    t_hi = max(float(s.get("ts", 0.0)) + float(s.get("dur", 0.0))
               for s in spans)
    return {
        "wall_ms": (t_hi - t_lo) / 1e3,
        "spans": len(spans),
        "by_stage_ms": dict(
            sorted(by_stage.items(), key=lambda kv: -kv[1])
        ),
        "by_category_ms": {c: v for c, v in by_cat.items() if v > 0.0},
    }


def critical_path(spans: list[dict]) -> list[dict]:
    """The deepest-wait chain: from each root span (parent outside the
    trace), descend into the child contributing the most wall time.
    Returns ``[{stage, rank, ms, exclusive_ms}, ...]`` root-first."""
    ids = _span_ids(spans)
    kids = _children(spans)
    roots = [
        s for s in spans if s["args"].get("parent", 0) not in ids
    ]
    if not roots:
        return []
    root = max(roots, key=lambda s: float(s.get("dur", 0.0)))
    path: list[dict] = []
    node: dict | None = root
    seen: set[int] = set()
    while node is not None:
        sid = node["args"].get("span_id")
        if sid in seen:  # defensive: malformed parent loops
            break
        seen.add(sid)
        own_kids = kids.get(sid, [])
        covered = _union_ms(
            [(float(c.get("ts", 0.0)),
              float(c.get("ts", 0.0)) + float(c.get("dur", 0.0)))
             for c in own_kids]
        )
        path.append({
            "stage": node.get("name", "?"),
            "rank": node.get("pid", 0),
            "ms": float(node.get("dur", 0.0)) / 1e3,
            "exclusive_ms": max(
                float(node.get("dur", 0.0)) / 1e3 - covered, 0.0
            ),
        })
        node = max(
            own_kids, key=lambda c: float(c.get("dur", 0.0)), default=None
        )
    return path


def _quantile_trace(
    ranked: list[tuple[float, int]], q: float
) -> tuple[float, int]:
    i = min(len(ranked) - 1, max(0, int(round(q * (len(ranked) - 1)))))
    return ranked[i]


def report(events: Iterable[dict]) -> dict[str, Any]:
    """Roll every trace in ``events`` into a p50/p99 attribution block:
    which category held the median and the tail request, and the tail
    request's critical path."""
    traces = group_traces(events)
    if not traces:
        return {"requests": 0}
    per: dict[int, dict] = {tid: attribute(spans) for tid, spans in traces.items()}
    ranked = sorted(
        ((info["wall_ms"], tid) for tid, info in per.items())
    )
    mean_cat: dict[str, float] = {}
    for info in per.values():
        for cat, ms in info["by_category_ms"].items():
            mean_cat[cat] = mean_cat.get(cat, 0.0) + ms
    n = len(per)
    out: dict[str, Any] = {
        "requests": n,
        "mean_by_category_ms": {
            c: v / n for c, v in sorted(mean_cat.items(), key=lambda kv: -kv[1])
        },
    }
    for label, q in (("p50", 0.50), ("p99", 0.99)):
        wall, tid = _quantile_trace(ranked, q)
        info = per[tid]
        out[label] = {
            "trace_id": tid,
            "wall_ms": wall,
            "by_category_ms": info["by_category_ms"],
            "by_stage_ms": dict(
                list(info["by_stage_ms"].items())[:8]
            ),
        }
    _, tail_tid = ranked[-1]
    out["slowest"] = {
        "trace_id": tail_tid,
        "wall_ms": ranked[-1][0],
        "critical_path": critical_path(traces[tail_tid]),
    }
    return out
