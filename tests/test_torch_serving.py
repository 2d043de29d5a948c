"""The port's serving layer (``pathway_tpu_torch/serving/``) against the JAX
package's (``pathway_tpu/serving/``), on the CPU.

Every case runs the same calls through both packages and compares what
comes out:

- admission: the call sequences of ``tests/test_serving.py`` and
  ``tests/test_overload.py`` (token bucket, queue cap, unknown tenant,
  ``wait_admit``, brownout and its recovery, ``push_pressure``) under one
  injected clock: the same admits and sheds, ``Retry-After`` within 1e-9,
  equal ``stats()``;
- the SLO scheduler: the dispatch order of a fixed backlog under
  weighted-fair queueing, the batch targets, the pressure stretch;
- the co-scheduler (lookahead on and off) and ``RagServingApp`` over
  ``HashingEmbedder`` and a brute-force ``SegmentedIndex(ShardedKnnIndex)``
  (the port's on the CPU), and over the tiny f32 encoder with the same
  flax parameters: the same chunk ids and answers, scores within 1e-6
  (1e-5 through the encoder);
- failover: a shard killed under load answers partially, a restore gives
  full recall and the hits of the JAX package, the supervisor restores on
  its own, a stale probe recovers after ``load_state_dict``;
- the load generator, the analyzer over the serving graph, and A11's
  serving lanes.

Waits are on events, hubs and deadlines, never a fixed sleep.
"""

from __future__ import annotations

import os
import textwrap
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu_torch.parallel import TorchEncoder
from tests.test_torch_encoder import port_config

D = 32
K = 5
SCORE_TOL = 1e-6  # f32 dots of unit rows over 32 dims, summed in another order
ENCODER_TOL = 1e-5  # the tiny f32 encoder's embeddings, then the dots
DEADLINE_S = 30.0


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
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


def package(name: str) -> SimpleNamespace:
    """One package's serving layer and the index classes it serves over;
    the port's slab lies on the CPU."""
    if name == "jax":
        from pathway_tpu import serving
        from pathway_tpu.analysis import device as dev
        from pathway_tpu.parallel import ShardedKnnIndex
        from pathway_tpu.serving import failover, loadgen
        from pathway_tpu.stdlib.indexing.segments import SegmentedIndex

        return SimpleNamespace(name=name, pw=jpw, serving=serving, failover=failover, loadgen=loadgen, dev=dev,
                               seg=SegmentedIndex, knn=lambda dim, **kw: ShardedKnnIndex(dim, **kw),
                               RetryLater=jpw.io.http.RetryLater)
    from pathway_tpu_torch import serving
    from pathway_tpu_torch.analysis import device as dev
    from pathway_tpu_torch.parallel import ShardedKnnIndex
    from pathway_tpu_torch.serving import failover, loadgen
    from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

    return SimpleNamespace(name=name, pw=tpw, serving=serving, failover=failover, loadgen=loadgen, dev=dev,
                           seg=SegmentedIndex, knn=lambda dim, **kw: ShardedKnnIndex(dim, device="cpu", **kw),
                           RetryLater=tpw.io.http.RetryLater)


BOTH = ("jax", "port")


def close(got, want, tol: float = 1e-9, where: str = "") -> None:
    """``got == want`` with floats within ``tol``, through dicts, lists
    and tuples."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(float(got) - float(want)) <= tol, (where, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (where, got, want)
        for key in want:
            close(got[key], want[key], tol, f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, tol, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def same_hits(got: list, want: list, tol: float, where: str = "") -> None:
    """Two ranked ``[(id, score), ...]`` lists: scores within ``tol``
    place by place, ids equal except where a tie within ``tol`` lets two
    swap (inside the list, or across its cut at k: which of two equal
    slab rows a top-k keeps depends on the slots the rows got)."""
    assert len(got) == len(want), (where, got, want)
    assert len({g for g, _ in got}) == len(got), (where, got)
    for i, ((gid, gs), (wid, ws)) in enumerate(zip(got, want)):
        assert abs(gs - ws) <= tol, (where, i, got, want)
        if gid != wid:
            # a swap inside the list: the id sits at a place of equal score
            inside = [s for w, s in want if w == gid]
            assert not inside or abs(inside[0] - gs) <= tol, (where, i, got, want)


def same_answers(got: list, want: list, tol: float) -> None:
    """The co-scheduler's answer dicts: equal but for scores (``tol``),
    latency and trace ids."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        same_hits([(d["id"], d["score"]) for d in g["docs"]], [(d["id"], d["score"]) for d in w["docs"]], tol,
                  f"answer {i}")
        for field in ("tenant_class", "partial", "shards_answered", "shards_total"):
            assert g[field] == w[field], (i, field, g[field], w[field])
        if [d["id"] for d in g["docs"]] == [d["id"] for d in w["docs"]]:
            assert g["answer"] == w["answer"] and [d["text"] for d in g["docs"]] == [d["text"] for d in w["docs"]]


# ---------------------------------------------------------------------------
# corpus


VOCAB = [f"w{i}" for i in range(160)]


def corpus(n: int, seed: int, lo: int = 6, hi: int = 30) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    return [(f"doc{i}", " ".join(rng.choice(VOCAB, int(rng.integers(lo, hi))))) for i in range(n)]


def questions(docs: list, n: int, seed: int) -> list[str]:
    """A few words of a random document each."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.integers(0, len(docs), n):
        words = docs[int(i)][1].split()
        start = int(rng.integers(0, max(1, len(words) - 4)))
        out.append(" ".join(words[start : start + 4]))
    return out


# ---------------------------------------------------------------------------
# admission


def admission_trace(p, policies: dict, steps: list, default: dict | None = None, t0: float = 100.0) -> list:
    """Run ``steps`` through one controller of package ``p`` under an
    injected clock; each step's outcome, in order."""
    clock = [t0]
    ac = p.serving.AdmissionController(
        {t: p.serving.TenantPolicy(**kw) for t, kw in policies.items()},
        default_policy=p.serving.TenantPolicy(**default) if default else None,
        clock=lambda: clock[0],
    )
    tickets: list = []
    out: list = []
    for op, *args in steps:
        if op in ("admit", "admit_release"):
            try:
                ticket = ac.admit(args[0], route="/v1/answer")
            except p.RetryLater as e:
                out.append(("shed", e.retry_after, str(e)))
                continue
            out.append(("ok", ticket.tenant, ticket.tenant_class))
            if op == "admit_release":
                ticket.release()
            else:
                tickets.append(ticket)
        elif op == "try":
            ticket = ac.try_admit(args[0])
            out.append(("try", None if ticket is None else ticket.tenant_class))
            if ticket is not None:
                tickets.append(ticket)
        elif op == "advance":
            clock[0] += args[0]
        elif op == "release":
            tickets[args[0]].release()
        elif op == "pressure":
            ac.set_pressure(*args)
        elif op == "policy":
            out.append(("policy", ac.policy(args[0]).tenant_class))
        elif op == "level":
            out.append(("level", ac.pressure_level()))
        elif op == "stats":
            out.append(("stats", ac.stats()))
        else:
            raise ValueError(op)
    return out


BROWNOUT_POLICIES = {
    "live": dict(tenant_class="interactive", rate_per_s=100, queue_cap=64),
    "bulk": dict(tenant_class="batch", rate_per_s=100, queue_cap=64),
}

ADMISSION = {
    # tests/test_serving.py: test_token_bucket_sheds_over_rate_and_recovers
    "token_bucket": (
        {"t": dict(tenant_class="batch", rate_per_s=2.0, burst=2, queue_cap=100)}, None,
        [("admit", "t"), ("admit", "t"), ("admit", "t"), ("stats",), ("advance", 0.5), ("admit", "t"),
         ("stats",), ("release", 0), ("release", 1), ("release", 2), ("stats",), ("advance", 0.25),
         ("admit", "t"), ("admit", "t"), ("stats",)],
    ),
    # test_queue_cap_bounds_inflight_per_tenant (release is idempotent)
    "queue_cap": (
        {"t": dict(tenant_class="interactive", rate_per_s=1000.0, queue_cap=2)}, None,
        [("admit", "t"), ("admit", "t"), ("admit", "t"), ("release", 0), ("release", 0), ("admit", "t"),
         ("stats",)],
    ),
    # test_unknown_tenant_uses_default_policy
    "unknown_tenant": (
        {}, dict(tenant_class="batch", rate_per_s=10.0),
        [("policy", "nobody"), ("admit", "nobody"), ("stats",), ("release", 0), ("stats",)],
    ),
    # tests/test_overload.py: test_brownout_sheds_batch_before_interactive
    "brownout": (
        BROWNOUT_POLICIES, None,
        [("pressure", "engine", 0.6)]
        + [step for _ in range(10) for step in (("advance", 0.01), ("admit_release", "live"),
                                                ("admit_release", "bulk"))]
        + [("stats",), ("level",)],
    ),
    # test_brownout_recovers_when_pressure_clears
    "brownout_recovery": (
        BROWNOUT_POLICIES, None,
        [("pressure", "engine", 0.9), ("try", "bulk"), ("try", "live"), ("pressure", "engine", 0.0),
         ("advance", 0.1), ("try", "bulk"), ("release", 0), ("release", 1), ("level",), ("stats",)],
    ),
    # a full brownout sheds every class with the drain-derived Retry-After
    "brownout_full": (
        BROWNOUT_POLICIES, None,
        [("admit", "live"), ("advance", 0.2), ("release", 0), ("admit", "live"), ("advance", 0.1),
         ("release", 1), ("pressure", "engine", 1.0), ("admit", "live"), ("admit", "bulk"),
         ("pressure", "other", 0.3), ("pressure", "engine", 0.0), ("level",), ("admit", "bulk"), ("stats",)],
    ),
}


@pytest.mark.parametrize("name", sorted(ADMISSION))
def test_admission_sequences_match_jax(name):
    policies, default, steps = ADMISSION[name]
    want = admission_trace(package("jax"), policies, steps, default)
    got = admission_trace(package("port"), policies, steps, default)
    close(got, want, 1e-9, name)
    assert any(o[0] == "shed" for o in want) or name in ("unknown_tenant", "brownout_recovery")


def test_admission_sheds_with_the_port_retry_later():
    """``_retry_later`` raises the port's own ``io/http`` ``RetryLater``,
    not a second class."""
    p = package("port")
    ac = p.serving.AdmissionController({"t": p.serving.TenantPolicy(rate_per_s=1.0, burst=1)}, clock=lambda: 0.0)
    ac.admit("t")
    with pytest.raises(tpw.io.http.RetryLater, match="rate limited: tenant 't'"):
        ac.admit("t")


@pytest.mark.parametrize("name", BOTH)
def test_wait_admit_unparks_on_ticket_release(name):
    """A waiter on a full queue parks on the hub and is admitted by the
    release, not by its deadline: the clock never moves."""
    p = package(name)
    calls = [0]
    parked = threading.Event()

    def clock() -> float:
        if threading.current_thread().name == "waiter":
            calls[0] += 1
            if calls[0] >= 3:  # the deadline, the admit probe, the remaining time: about to park
                parked.set()
        return 5.0

    ac = p.serving.AdmissionController(
        {"t": p.serving.TenantPolicy("interactive", rate_per_s=1000.0, queue_cap=1)}, clock=clock)
    held = ac.admit("t")
    got = {}
    waiter = threading.Thread(target=lambda: got.setdefault("ticket", ac.wait_admit("t", timeout=5.0)),
                              name="waiter", daemon=True)
    waiter.start()
    assert parked.wait(DEADLINE_S)
    held.release()
    waiter.join(DEADLINE_S)
    assert not waiter.is_alive() and got["ticket"].tenant_class == "interactive"
    got["ticket"].release()
    stats = ac.stats()
    assert stats["admitted_total"] == {"interactive": 2} and stats["shed_total"] == {}
    assert stats["inflight"] == {}


def test_push_pressure_fans_out_to_live_controllers():
    levels = {}
    for name in BOTH:
        p = package(name)
        t = [0.0]
        acs = [p.serving.AdmissionController({"live": p.serving.TenantPolicy("interactive")}, clock=lambda: t[0])
               for _ in range(2)]
        sched = p.serving.SloScheduler(idle_wait_s=0.01)
        try:
            p.serving.push_pressure("engine", 0.7)
            seen = [a.pressure_level() for a in acs] + [sched.stats()["pressure"]]
            snap = p.serving.serving_snapshot()["admission"]["pressure_level"]
            p.serving.push_pressure("engine", 0.0)
            seen += [a.pressure_level() for a in acs] + [sched.stats()["pressure"]]
            levels[name] = (seen, snap)
        finally:
            sched.close()
    assert levels["port"] == levels["jax"] == ([0.7, 0.7, 0.7, 0.0, 0.0, 0.0], 0.7)


# ---------------------------------------------------------------------------
# SLO scheduler


def gated(p, lanes: dict, **kw):
    """A scheduler whose dispatcher is busy on a gate task (already
    dispatched), so a backlog can be queued before any decision."""
    s = p.serving.SloScheduler(lanes=lanes, idle_wait_s=0.01, **kw)
    gate, started = threading.Event(), threading.Event()
    s.submit(next(iter(lanes)), "interactive", lambda _x: (started.set(), gate.wait(DEADLINE_S)))
    assert started.wait(DEADLINE_S)
    return s, gate


def wfq_order(p, pressure: float) -> tuple:
    s, gate = gated(p, {"embed": 1.0})
    order: list = []
    try:
        s.set_pressure(pressure)
        for i in range(10):
            s.submit("embed", "batch", lambda _x, i=i: order.append(("batch", i)))
        for i in range(10):
            s.submit("embed", "interactive", lambda _x, i=i: order.append(("interactive", i)))
        with s._lock:
            vfinish = sorted((key[1], t.vfinish) for key, q in s._queues.items() for t in q)
        gate.set()
        assert s.drain(DEADLINE_S)
        stats = s.stats()
        return order, vfinish, stats["classes"], stats["submitted"], stats["completed"], stats["pressure"]
    finally:
        gate.set()
        s.close()


@pytest.mark.parametrize("pressure", [0.0, 0.8], ids=["steady", "brownout"])
def test_wfq_dispatch_order_matches_jax(pressure):
    """A backlog of 10 batch then 10 interactive tasks behind a gate: the
    same dispatch order, virtual finish times and class counts; under
    pressure the batch class is stretched further behind."""
    want = wfq_order(package("jax"), pressure)
    got = wfq_order(package("port"), pressure)
    close(got, want, 1e-12)
    order = want[0]
    assert [c for c, _ in order[:12]].count("interactive") >= 9
    assert want[2]["interactive"]["dispatched"] == 11 and want[2]["batch"]["dispatched"] == 10


def batch_targets(p) -> list:
    s = p.serving.SloScheduler(lanes={"embed": 1.0}, target_ms={"embed": 4.0}, max_batch=16)
    out = []
    try:
        with s._lock:
            out.append(s._batch_target_locked("embed"))
            for ewma in (2e6, 8e6, 1e3, 4e6, 3.9e6, 2.5e5, 1.3e6):
                s._ewma_item_ns["embed"] = ewma
                out.append(s._batch_target_locked("embed"))
    finally:
        s.close()
    return out


def test_batch_targets_match_jax():
    assert batch_targets(package("port")) == batch_targets(package("jax")) == [16, 2, 1, 16, 1, 1, 16, 3]


def first_coalesced_batch(p) -> tuple:
    """A gated coalescable backlog with a 2 ms/item EWMA against a 4 ms
    target: the first batch takes 2 items.  The gate runs on a lane of its
    own, so its time does not enter the embed lane's EWMA."""
    s, gate = gated(p, {"gate": 1.0, "embed": 1.0}, target_ms={"embed": 4.0}, max_batch=16)
    batches: list = []
    try:
        with s._lock:
            s._ewma_item_ns["embed"] = 2e6
        futs = [s.submit("embed", "interactive", lambda items: (batches.append(len(items)), [x * 2 for x in items])[1],
                         item=i, coalesce="w") for i in range(16)]
        gate.set()
        assert s.drain(DEADLINE_S)
        return batches[0], [f.result(timeout=DEADLINE_S) for f in futs], sum(batches)
    finally:
        gate.set()
        s.close()


def test_latency_aware_first_batch_matches_jax():
    assert first_coalesced_batch(package("port")) == first_coalesced_batch(package("jax")) == (
        2, [i * 2 for i in range(16)], 16)


def scheduler_errors(p) -> list:
    s = p.serving.SloScheduler(lanes={"embed": 1.0}, idle_wait_s=0.01)
    out = []
    try:
        s.submit("gpu", "interactive", lambda _x: None)
    except KeyError as e:
        out.append(str(e))
    out.append(s.submit("embed", "interactive", lambda _x: 7).result(timeout=DEADLINE_S))
    s.ensure_lane("recover", share=0.25)
    out.append(s.submit("recover", "batch", lambda x: x + 1, 1).result(timeout=DEADLINE_S))
    out.append(sorted(s.stats()["lanes"]))
    s.close()
    try:
        s.submit("embed", "interactive", lambda _x: None)
    except RuntimeError as e:
        out.append(str(e))
    return out


def test_scheduler_lanes_and_close_match_jax():
    assert scheduler_errors(package("port")) == scheduler_errors(package("jax"))
    assert scheduler_errors(package("port"))[-1] == "scheduler closed"


# ---------------------------------------------------------------------------
# co-scheduler


DOCS = corpus(60, seed=3)
QUESTIONS = questions(DOCS, 12, seed=4)


def hashing_corpus_index(p, emb):
    """40 documents bulk-loaded into the slab, 10 more in the delta
    segment, 3 of the slab's deleted (tombstones)."""
    seg = p.seg(p.knn(D, metric="cos", capacity=256), delta_cap=8, auto_merge=False)
    seg.add([(doc_id, emb(text)) for doc_id, text in DOCS[:40]])
    for doc_id, text in DOCS[40:50]:
        seg.add([(doc_id, emb(text))])
    seg.remove(["doc3", "doc7", "doc11"])
    return seg


def coscheduled(p, lookahead: bool) -> tuple:
    emb = p.serving.HashingEmbedder(D)
    seg = hashing_corpus_index(p, emb)
    texts = dict(DOCS)
    sched = p.serving.SloScheduler(idle_wait_s=0.01)
    cos = p.serving.StageCoScheduler(embedder=emb, index=seg, doc_text=lambda key: texts.get(key, ""),
                                     scheduler=sched, k=K, lookahead=lookahead)
    try:
        futs = [cos.submit(q, tenant_class=("interactive", "batch")[i % 2]) for i, q in enumerate(QUESTIONS)]
        out = [f.result(timeout=DEADLINE_S) for f in futs]
        return out, cos.stats(), seg.stats()
    finally:
        cos.close()
        sched.close()
        seg.close()


@pytest.mark.parametrize("lookahead", [True, False], ids=["lookahead", "search"])
def test_coscheduler_matches_jax(lookahead):
    want, wstats, wseg = coscheduled(package("jax"), lookahead)
    got, gstats, gseg = coscheduled(package("port"), lookahead)
    same_answers(got, want, SCORE_TOL)
    assert all(len(r["docs"]) == K for r in got)
    assert not any(d["id"] in ("doc3", "doc7", "doc11") for r in got for d in r["docs"])
    for key in ("completed", "failed", "degraded_responses", "lookahead_probes", "gen_queued"):
        assert gstats[key] == wstats[key], key
    assert gstats["lookahead_probes"] == (len(QUESTIONS) if lookahead else 0)
    # the plain search is a dispatch + collect pair too
    assert gseg["probes_dispatched"] == wseg["probes_dispatched"] == len(QUESTIONS)
    assert gseg["probes_recovered"] == wseg["probes_recovered"] == 0


def test_extractive_answerer_matches_jax():
    from pathway_tpu.serving.coscheduler import extractive_answerer as jans
    from pathway_tpu_torch.serving.coscheduler import extractive_answerer as tans

    docs = [{"id": "a#0", "text": "x" * 300, "score": 0.5}]
    assert tans("q", docs) == jans("q", docs) and tans("q", []) == jans("q", [])


def test_hashing_embedder_and_splitter_match_jax():
    from pathway_tpu.serving.graph import simple_splitter as jsplit
    from pathway_tpu_torch.serving.graph import simple_splitter as tsplit

    for dim in (4, 32, 768):
        je, te = package("jax").serving.HashingEmbedder(dim), package("port").serving.HashingEmbedder(dim)
        assert te.dim == je.dim
        for _, text in DOCS[:10]:
            assert np.array_equal(te(text), je(text))
    for doc_id, text in DOCS[:10]:
        for words in (3, 12, 48):
            assert tsplit(doc_id, text, words) == jsplit(doc_id, text, words)
    assert tsplit("e", "") == jsplit("e", "") == []


# ---------------------------------------------------------------------------
# RagServingApp end to end


def policies(p) -> dict:
    return {
        "alice": p.serving.TenantPolicy("interactive", rate_per_s=500.0, burst=50, queue_cap=64),
        "bob": p.serving.TenantPolicy("batch", rate_per_s=500.0, burst=50, queue_cap=64),
    }


def settle(app, live: set, ingested: int) -> None:
    """Wait on the app's hub until the index holds exactly ``live`` and at
    least ``ingested`` chunks went through the embed lane."""
    deadline = time.monotonic() + DEADLINE_S
    while True:
        seen = app.hub.seq()
        if app.ingested_chunks >= ingested and set(app.index.keys()) == live:
            return
        assert time.monotonic() < deadline, (app.stats(), len(live))
        app.hub.wait(seen, 0.05)


def chunk_ids(p, docs, chunk_words: int) -> list:
    return [cid for doc_id, text in docs for cid, _ in p.serving.simple_splitter(doc_id, text, chunk_words)]


REWRITTEN = corpus(6, seed=9, lo=4, hi=40)  # new texts for doc0..doc5
DELETED = ("doc6", "doc7", "doc8")
CHUNK_WORDS = 8


def serve_app(p, embedder, docs, asked, k: int = K) -> dict:
    """Upsert ``docs``, answer ``asked``, rewrite and delete some, answer
    again: both rounds, the admission stats and the live chunk ids."""
    p.pw.G.clear()
    index = p.seg(p.knn(embedder.dim, metric="cos", capacity=512), delta_cap=16)
    app = p.serving.RagServingApp(policies(p), embedder=embedder, index=index, k=k, chunk_words=CHUNK_WORDS,
                                  autocommit_ms=10)
    app.start()
    try:
        tenants = ("alice", "bob")
        for i, (doc_id, text) in enumerate(docs):
            app.upsert(doc_id, text, tenant=tenants[i % 2])
        first_ids = chunk_ids(p, docs, CHUNK_WORDS)
        settle(app, set(first_ids), len(first_ids))
        first = [app.answer(q, tenant=tenants[i % 2], timeout=DEADLINE_S) for i, q in enumerate(asked)]
        rewritten = [(doc_id, text) for (doc_id, _), (_, text) in zip(docs, REWRITTEN)]
        for doc_id, text in rewritten:
            app.upsert(doc_id, text, tenant="alice")
        for doc_id in DELETED:
            app.delete(doc_id)
        final = dict(docs)
        final.update(rewritten)
        for doc_id in DELETED:
            del final[doc_id]
        live = chunk_ids(p, list(final.items()), CHUNK_WORDS)
        settle(app, set(live), len(first_ids) + len(chunk_ids(p, rewritten, CHUNK_WORDS)))
        second = [app.answer(q, tenant=tenants[i % 2], timeout=DEADLINE_S) for i, q in enumerate(asked)]
        stats = app.stats()
        stats["admission"]["pressure"].pop("drain_s")  # the wall clock's gaps between releases
        return {"first": first, "second": second, "admission": stats["admission"], "live": sorted(live),
                "merges": stats["index"]["merges_total"], "co": stats["coscheduler"]}
    finally:
        app.close()
        p.pw.G.clear()


def test_rag_serving_app_matches_jax():
    docs = DOCS[:36]
    asked = QUESTIONS + [REWRITTEN[0][1][:30], "w1 w2 w3"]
    want = serve_app(package("jax"), package("jax").serving.HashingEmbedder(D), docs, asked)
    got = serve_app(package("port"), package("port").serving.HashingEmbedder(D), docs, asked)
    same_answers(got["first"], want["first"], SCORE_TOL)
    same_answers(got["second"], want["second"], SCORE_TOL)
    assert got["admission"] == want["admission"]
    assert got["admission"]["admitted_total"] == {"interactive": len(asked), "batch": len(asked)}
    assert got["live"] == want["live"]
    gone = {f"{d}#" for d in DELETED}
    assert not any(d["id"].startswith(tuple(gone)) for r in got["second"] for d in r["docs"])
    assert got["merges"] > 0 and got["co"]["lookahead_probes"] == 2 * len(asked)


class EncoderAdapter:
    """A text encoder as the serving layer's embedder: one text a call."""

    def __init__(self, encoder, dim: int):
        self.encoder = encoder
        self.dim = dim

    def __call__(self, text: str) -> np.ndarray:
        return self.encoder.encode([text])[0]


@pytest.fixture(scope="module")
def tiny_encoders():
    jcfg = graft._flagship_config(tiny=True)
    params = jax.tree.map(np.asarray, JittedEncoder(jcfg).params)
    return (EncoderAdapter(JittedEncoder(jcfg, params=params), jcfg.hidden),
            EncoderAdapter(TorchEncoder(port_config(jcfg), params=params, device="cpu"), jcfg.hidden))


def test_rag_serving_app_over_the_tiny_encoder_matches_jax(tiny_encoders):
    """The chip phase's configuration at a tiny width: the encoder as the
    embedder, the slab as the index."""
    jemb, temb = tiny_encoders
    docs = DOCS[:12]
    asked = QUESTIONS[:6]
    want = serve_app(package("jax"), jemb, docs, asked, k=4)
    got = serve_app(package("port"), temb, docs, asked, k=4)
    same_answers(got["first"], want["first"], ENCODER_TOL)
    same_answers(got["second"], want["second"], ENCODER_TOL)
    assert got["live"] == want["live"] and got["admission"] == want["admission"]


# ---------------------------------------------------------------------------
# failover


def partitioned(p, n_docs: int = 120, seed: int = 0):
    rng = np.random.default_rng(seed)
    part = p.serving.PartitionedIndex(
        lambda: p.seg(p.knn(D, metric="cos", capacity=256), delta_cap=64, auto_merge=False),
        n_shards=2, snapshot_every=32)
    vecs = rng.standard_normal((n_docs, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    corpus_ = {f"d{i}": vecs[i] for i in range(n_docs)}
    part.add(list(corpus_.items()))
    return part, corpus_, rng


def brute_topk(corpus_: dict, q: np.ndarray, k: int) -> list:
    ids = sorted(corpus_)
    scores = np.stack([corpus_[i] for i in ids]) @ (q / np.linalg.norm(q))
    return [(ids[i], float(scores[i])) for i in np.argsort(-scores, kind="stable")[:k]]


def failover_drill(p) -> dict:
    """Phased: healthy answers, one owner killed, writes during the
    outage, a restore; the coverage and hits of each phase."""
    part, corpus_, rng = partitioned(p)
    co = p.serving.StageCoScheduler(embedder=p.serving.HashingEmbedder(dim=D), index=part, k=K, lookahead=True)
    asked = [f"query {i % 7} alpha w{i}" for i in range(12)]

    def round_() -> list:
        return [f.result(timeout=DEADLINE_S) for f in [co.submit(q, "interactive") for q in asked]]

    try:
        out = {"healthy": round_()}
        part.fail_shard(1)
        out["degraded"] = round_()
        extra = rng.standard_normal((24, D)).astype(np.float32)
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        part.add([(f"x{j}", extra[j]) for j in range(24)])
        corpus_.update({f"x{j}": extra[j] for j in range(24)})
        out["outage_writes"] = round_()
        out["failover_s"] = part.recover_shard(1)
        out["recovered"] = round_()
        queries = rng.standard_normal((10, D)).astype(np.float32)
        out["search"] = part.search(queries, K)
        out["brute"] = [brute_topk(corpus_, q, K) for q in queries]
        out["len"], out["n_corpus"] = len(part), len(corpus_)
        out["owners"] = [(o.alive, o.restores_total, o.tail_replayed, o.incarnation) for o in part.owners]
        st = part.stats()
        out["stats"] = {key: st[key] for key in ("shards_total", "shards_healthy", "degraded_responses",
                                                  "failovers_total", "probes_recovered", "standby_serves")}
        out["co"] = co.stats()["degraded_responses"]
        return out
    finally:
        co.close()
        co.scheduler.close()
        part.close()


def test_failover_drill_matches_jax():
    want = failover_drill(package("jax"))
    got = failover_drill(package("port"))
    for phase in ("healthy", "degraded", "outage_writes", "recovered"):
        same_answers(got[phase], want[phase], SCORE_TOL)
    assert all(r["partial"] is False and r["shards_answered"] == 2 for r in got["healthy"] + got["recovered"])
    assert all(r["partial"] is True and r["shards_answered"] == 1 and r["shards_total"] == 2
               for r in got["degraded"] + got["outage_writes"])
    for g, w, b in zip(got["search"], want["search"], got["brute"]):
        same_hits(g, w, SCORE_TOL)
        same_hits(g, b, SCORE_TOL)  # recall back to 1.0 against brute force
    assert got["len"] == want["len"] == got["n_corpus"]
    assert got["owners"] == want["owners"]
    assert got["owners"][0][1] == 0 and got["owners"][1][1] == 1 and got["owners"][1][2] > 0
    assert got["stats"] == want["stats"] and got["co"] == want["co"] > 0
    assert got["failover_s"] >= 0.0


@pytest.mark.parametrize("name", BOTH)
def test_shard_killed_mid_load_answers_partially(name):
    """One owner dies while queries are in flight: every response resolves,
    the degraded ones say ``partial`` with 1 of 2 shards."""
    p = package(name)
    part, corpus_, _ = partitioned(p)
    co = p.serving.StageCoScheduler(embedder=p.serving.HashingEmbedder(dim=D), index=part, k=K, lookahead=True)
    results: list = []
    errors: list = []
    stop, some = threading.Event(), threading.Event()

    def load() -> None:
        i = 0
        while not stop.is_set():
            try:
                results.append(co.submit(f"query {i % 7} alpha", "interactive").result(timeout=DEADLINE_S))
            except BaseException as e:  # noqa: BLE001 - the drill counts them
                errors.append(e)
            i += 1
            if len(results) >= 5:
                some.set()

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        assert some.wait(DEADLINE_S)
        part.fail_shard(1)
        n = len(results)
        deadline = time.monotonic() + DEADLINE_S
        while len(results) < n + 10 and time.monotonic() < deadline:
            stop.wait(0.01)
        stop.set()
        t.join(DEADLINE_S)
        assert not errors, errors[:3]
        coverage = {(r["partial"], r["shards_answered"], r["shards_total"]) for r in results}
        assert (True, 1, 2) in coverage and coverage <= {(False, 2, 2), (True, 1, 2)}
        assert part.owners[0].restores_total == 0
    finally:
        stop.set()
        co.close()
        co.scheduler.close()
        part.close()


def supervised(p) -> tuple:
    part, corpus_, rng = partitioned(p, n_docs=60)
    sched = p.serving.SloScheduler(idle_wait_s=0.01)
    sup = p.serving.ShardFailoverSupervisor(part, poll_interval_s=0.02, scheduler=sched)
    try:
        before = part.search(rng.standard_normal((4, D)), K)
        part.fail_shard(0)
        deadline = time.monotonic() + DEADLINE_S
        while part.owners[0].restores_total == 0 and time.monotonic() < deadline:
            sup._stopped.wait(0.01)
        assert part.owners[0].alive, "the supervisor never restored the shard"
        assert sched.drain(DEADLINE_S)
        hist = part.stats()["failover_seconds"]
        rng2 = np.random.default_rng(0)
        part2_q = rng2.standard_normal((4, D))
        return (part.stats()["shards_healthy"], hist["count"], hist["max_ns"] > 0,
                sorted(sched.stats()["lanes"]), sched.stats()["classes"]["batch"]["dispatched"],
                part.search(part2_q, K), before)
    finally:
        sup.close()
        sched.close()
        part.close()


def test_failover_supervisor_restores_dead_shard():
    want = supervised(package("jax"))
    got = supervised(package("port"))
    assert got[:5] == want[:5] == (2, 1, True, ["embed", "recover", "search"], 1)
    for g, w in zip(got[5] + got[6], want[5] + want[6]):
        same_hits(g, w, SCORE_TOL)


def health_trace(p) -> list:
    t = p.failover.ShardHealthTracker(2, dead_after=2)
    out = [t.healthy_count()]
    for op, sid in (("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0), ("ok", 0), ("suspect", 1), ("ok", 1),
                    ("suspect", 1), ("dead", 1), ("revive", 0)):
        {"fail": lambda s: t.record_failure(s, "boom"), "ok": t.record_success, "suspect": t.mark_suspect,
         "dead": lambda s: t.mark_dead(s, "killed"), "revive": t.revive}[op](sid)
        out.append((t.states(), t.dead_shards(), t.healthy_count()))
    out.append(t.snapshot())
    return out


def test_shard_health_tracker_matches_jax():
    assert health_trace(package("port")) == health_trace(package("jax"))


def stale_probe(p) -> tuple:
    rng = np.random.default_rng(8)
    seg = p.seg(p.knn(D, metric="cos", capacity=256), delta_cap=16, auto_merge=False)
    try:
        x = rng.standard_normal((40, D)).astype(np.float32)
        seg.add([(f"m{i}", x[i]) for i in range(32)])
        seg.add([(f"d{i}", x[32 + i]) for i in range(5)])
        seg.remove(["m3", "m7"])
        q = rng.standard_normal((3, D)).astype(np.float32)
        assert seg.collect(seg.dispatch(q, K)) == seg.search(q, K)
        handle = seg.dispatch(q, K)
        seg.load_state_dict(seg.state_dict())  # the owner restarts with the probe in flight
        got = seg.collect(handle)
        assert got == seg.search(q, K)
        return got, seg.stats()["probes_recovered"], seg.stats()["probes_dispatched"]
    finally:
        seg.close()


def test_stale_probe_recovers_after_restore():
    want = stale_probe(package("jax"))
    got = stale_probe(package("port"))
    assert got[1:] == want[1:] and got[1] == 1
    for g, w in zip(got[0], want[0]):
        same_hits(g, w, SCORE_TOL)


def test_partitioned_state_dict_roundtrip_matches_jax():
    out = {}
    for name in BOTH:
        p = package(name)
        part, corpus_, rng = partitioned(p, n_docs=50)
        other = p.serving.PartitionedIndex(
            lambda: p.seg(p.knn(D, metric="cos", capacity=256), delta_cap=64, auto_merge=False), n_shards=2)
        try:
            state = part.state_dict()
            other.load_state_dict(state)
            q = rng.standard_normal((5, D)).astype(np.float32)
            out[name] = (state["kind"], len(state["shards"]), sorted(other.keys()), other.search(q, K))
            with pytest.raises(ValueError, match="shard count mismatch"):
                p.serving.PartitionedIndex(lambda: p.seg(p.knn(D, capacity=256)), n_shards=3).load_state_dict(state)
        finally:
            part.close()
            other.close()
    assert out["port"][:3] == out["jax"][:3]
    for g, w in zip(out["port"][3], out["jax"][3]):
        same_hits(g, w, SCORE_TOL)


# ---------------------------------------------------------------------------
# load generator


def test_percentile_matches_jax():
    from pathway_tpu.serving.loadgen import percentile as jp
    from pathway_tpu_torch.serving.loadgen import percentile as tp

    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100):
        xs = [float(v) for v in rng.standard_normal(n)]
        for q in (0, 1, 50, 90, 99, 100):
            assert tp(xs, q) == jp(xs, q)
    assert tp([4.0, 1.0, 3.0, 2.0], 50) == 3.0


class RecordingTarget:
    """A LoadGen target that answers at once and records every call."""

    def __init__(self, p, policies_: dict):
        self.admission = p.serving.AdmissionController(policies_, clock=lambda: 0.0)
        self.calls: dict = {}

    def submit_query(self, query, tenant="default", k=None):
        from concurrent.futures import Future

        self.calls.setdefault(tenant, []).append(("query", query))
        ticket = self.admission.admit(tenant)
        fut: Future = Future()
        fut.set_result({"answer": query})
        ticket.release()
        return fut

    def upsert(self, doc_id, text, tenant="default"):
        self.calls.setdefault(tenant, []).append(("upsert", doc_id, text))


def loadgen_run(p) -> tuple:
    target = RecordingTarget(p, {
        "i": p.serving.TenantPolicy("interactive", rate_per_s=1000.0, burst=1000),
        "b": p.serving.TenantPolicy("batch", rate_per_s=2.0, burst=3, queue_cap=2),
    })
    lg = p.serving.LoadGen(target, [p.serving.TenantLoad("i", qps=400.0),
                                    p.serving.TenantLoad("b", qps=400.0, write_fraction=0.3, doc_words=5)],
                           duration_s=0.3, seed=42)
    return lg.run(), target


def test_loadgen_fire_schedule_and_report_match_jax():
    """The same seed fires the same calls in the same order (the common
    prefix: how many fit in the duration is the clock's), and the report
    has the same keys."""
    want, wt = loadgen_run(package("jax"))
    got, gt = loadgen_run(package("port"))
    for tenant in ("i", "b"):
        a, b = gt.calls.get(tenant, []), wt.calls.get(tenant, [])
        n = min(len(a), len(b))
        assert n >= 10 and a[:n] == b[:n], tenant
    assert got.keys() == want.keys() and got["seed"] == want["seed"] == 42
    assert got["tenants"].keys() == want["tenants"].keys() and got["classes"].keys() == want["classes"].keys()
    for tenant, row in got["tenants"].items():
        assert row.keys() == want["tenants"][tenant].keys()
        assert row["tenant_class"] == want["tenants"][tenant]["tenant_class"]
    for cls, row in got["classes"].items():
        assert row.keys() == want["classes"][cls].keys()
    i_row, b_row = got["tenants"]["i"], got["tenants"]["b"]
    assert i_row["shed"] == 0 and i_row["errors"] == 0 and i_row["completed"] == i_row["sent"] > 0
    assert b_row["shed"] > 0 and b_row["writes"] > 0
    assert b_row["writes"] == sum(1 for c in gt.calls["b"] if c[0] == "upsert")


# ---------------------------------------------------------------------------
# the analyzer over the serving graph


def serving_findings(p, shards) -> list:
    p.pw.G.clear()
    app = p.serving.RagServingApp(shards=shards, embed_dim=8, delta_cap=8, auto_merge=False)
    try:
        app.build()
        diags = p.pw.analyze()
        stages = sorted(n.meta["serving"]["stage"] for n in p.pw.G.engine_graph.nodes if "serving" in n.meta)
        return [(d.code, d.severity, d.node_id, d.node_name, d.message) for d in diags
                if not d.code.startswith("PW-J")], stages
    finally:
        app.close()
        p.pw.G.clear()


@pytest.mark.parametrize("shards", [None, 2], ids=["single_owner", "two_shards"])
def test_serving_graph_findings_match_jax(shards):
    want, wstages = serving_findings(package("jax"), shards)
    got, gstages = serving_findings(package("port"), shards)
    assert got == want
    assert gstages == wstages == ["chunk", "index-upsert", "ingest"]
    codes = {c for c, *_ in got}
    assert not [f for f in got if f[1] == "error"]
    assert ("PW-R002" in codes) == (shards is None)  # a single owner has no standby
    assert "PW-X001" not in codes  # the annotated upsert is order-safe


def test_serving_graph_anchors_the_device_scan_as_jax_does(tmp_path, monkeypatch):
    """A serving graph pulls in the whole device surface, anchored to its
    first annotated node, which is the JAX pass's anchor."""
    p = package("port")
    hot = tmp_path / "hot.py"
    hot.write_text(textwrap.dedent("""
        import torch
        def serve(outs):
            scores = []
            for o in outs:
                scores.append(o.max().item())
            return scores
        """))
    monkeypatch.setattr(p.dev, "device_module_files", lambda: [str(hot)])
    anchors = {}
    for name in BOTH:
        q = package(name)
        q.pw.G.clear()
        app = q.serving.RagServingApp(embed_dim=8)
        try:
            app.build()
            first = next(n for n in q.pw.G.engine_graph.nodes
                         if (n.meta or {}).get("serving") or (n.meta or {}).get("index_upsert"))
            anchors[name] = (first.id, type(first).__name__)
            if name == "port":
                found = [(d.code, d.node_id, d.node_name) for d in q.pw.analyze() if d.code.startswith("PW-J")]
        finally:
            app.close()
            q.pw.G.clear()
    assert anchors["port"] == anchors["jax"]
    assert found == [("PW-J002", *anchors["port"])]


# ---------------------------------------------------------------------------
# A11 over serving/


LANE_SNIPPET = """
    import torch
    class {cls}:
        def {fn}(self, queries):
            return [self.encoder(q).cpu() for q in queries]
    """


@pytest.mark.parametrize("path, cls, fn, flagged", [
    ("serving/coscheduler.py", "StageCoScheduler", "_embed_batch", True),
    ("serving/coscheduler.py", "StageCoScheduler", "_retrieve", True),
    ("serving/graph.py", "RagServingApp", "_ingest_batch", True),
    ("serving/coscheduler.py", "StageCoScheduler", "_generate", False),
    ("serving/loadgen.py", "StageCoScheduler", "_embed_batch", False),
])
def test_serving_lanes_are_slo_lanes(path, cls, fn, flagged):
    """A blocking readback in a serving stage that runs inside
    ``SloScheduler._execute`` is PW-J005; the same code off the lanes is
    not."""
    dev = package("port").dev
    diags = dev.scan_source(textwrap.dedent(LANE_SNIPPET.format(cls=cls, fn=fn)), f"pathway_tpu_torch/{path}")
    assert [(d.code, d.details.get("function")) for d in diags] == ([("PW-J005", f"{cls}.{fn}")] if flagged else [])


def test_serving_is_on_the_device_surface_and_scans_clean():
    dev = package("port").dev
    files = dev.device_module_files()
    assert len(files) == len(set(files))
    serving = sorted(os.path.basename(f) for f in files if os.path.basename(os.path.dirname(f)) == "serving")
    assert serving == ["__init__.py", "admission.py", "coscheduler.py", "failover.py", "graph.py", "loadgen.py",
                       "scheduler.py"]
    report = dev.scan_paths([f for f in files if os.path.basename(os.path.dirname(f)) == "serving"])
    assert report.diagnostics == (), [d.format() for d in report.diagnostics]


def test_all_matches_jax():
    assert package("port").serving.__all__ == package("jax").serving.__all__
    for name in package("port").serving.__all__:
        assert getattr(package("port").serving, name).__module__.startswith("pathway_tpu_torch.serving")
    assert tpw.serving is package("port").serving
