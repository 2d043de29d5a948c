"""The port's chaos harness (``pathway_tpu_torch/testing/chaos.py``)
against the JAX package's, on the CPU.

The cases of ``tests/test_chaos_recovery.py`` and
``tests/test_cluster_recovery.py`` run against the port with the same
markers; the seeded primitives give the same call counts and the same
delays as the JAX package's for the same seed; for the same seed the
port's ``ClusterDrill`` writes the same corpus and its recovered output
equals the JAX package's fault-free output byte for byte, and
``IndexDrill`` expects the same index size.  The overload drills of
``tests/test_overload.py`` (a firehose into a small ingest buffer, a
stalled sink, a slow consumer, exchange credit) and the kill-a-process
restarts of ``tests/test_multiworker.py`` run in both packages with the
same inputs.  Each drill program the port writes runs once in a
subprocess with ``jax`` and ``pathway_tpu`` blocked.
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.internals.resilience import ConnectorRecoveryPolicy
from pathway_tpu_torch.io._connector import DictSource, input_table
from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode, attach_persistence
from pathway_tpu_torch.testing import ChaosError, chaos, flaky_once
from pathway_tpu_torch.testing.chaos import ClusterDrill, IndexDrill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = tpw.G


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
    root = "pathway_tpu" if name == "jax" else "pathway_tpu_torch"
    return SimpleNamespace(
        name=name,
        pw=jpw if name == "jax" else tpw,
        chaos=import_module(f"{root}.testing.chaos"),
        cluster=import_module(f"{root}.engine.cluster"),
        scheduler=import_module(f"{root}.engine.scheduler"),
    )


BOTH = ("jax", "port")


def free_port_range(n: int) -> int:
    """A base port with ``n`` consecutive bindable ports, probed."""
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n > 65000:
            continue
        socks = []
        try:
            for i in range(n):
                t = socket.socket()
                t.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                t.bind(("127.0.0.1", base + i))
                socks.append(t)
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
        return base


def wait_for(pred, timeout_s: float, what: str, tick: threading.Event | None = None) -> None:
    """Poll ``pred`` on an event's timeout until it holds or the deadline."""
    tick = tick or threading.Event()
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        tick.wait(0.02)


# ---------------------------------------------------------------------------
# tests/test_chaos_recovery.py against the port


class WordSchema(tpw.Schema):
    word: str


# the JAX test's rows: under operator snapshots a restart re-fires only
# the groups it touches, and every group recurs after the first commit
ROWS = [{"word": w} for w in ["a", "b", "a", "c", "a", "b"]]
EXPECTED = {"a": 3, "b": 2, "c": 1}


def _build(gen, results, policy=None, name="wsrc"):
    src = DictSource(gen, WordSchema, commit_every=2)
    t = input_table(src, WordSchema, name=name, recovery_policy=policy)
    counts = t.groupby(t.word).reduce(t.word, n=tpw.reducers.count())

    def on_change(key, row, time, is_addition):
        if is_addition:
            results[row["word"]] = row["n"]
        elif results.get(row["word"]) == row["n"]:
            del results[row["word"]]

    tpw.io.subscribe(counts, on_change=on_change)


def _run(tmp_path, mode=None):
    sched = Scheduler(G.engine_graph, autocommit_ms=10)
    cfg = (Config.simple_config(Backend.filesystem(tmp_path / "snap")) if mode is None else
           Config.simple_config(Backend.filesystem(tmp_path / "snap"), persistence_mode=mode, snapshot_interval_ms=0))
    attach_persistence(sched, cfg)
    sched.run()
    return sched


@pytest.mark.chaos
def test_chaos_smoke():
    class Service:
        def __init__(self):
            self.calls = 0

        def ping(self):
            self.calls += 1
            return "pong"

    svc = Service()
    with chaos(seed=3) as c:
        c.raise_on_nth_call(svc, "ping", n=2)
        assert svc.ping() == "pong"
        with pytest.raises(ChaosError):
            svc.ping()
        assert svc.ping() == "pong"  # transient: only the 2nd call failed
        assert c.call_count(svc, "ping") == 3
        assert svc.calls == 2
    assert svc.ping() == "pong"  # patch restored on exit
    svc2 = Service()
    with chaos() as c:
        c.raise_on_nth_call(svc2, "ping", n=2, every=True)  # permanent fault
        c.inject_latency(svc2, "ping", delay_s=0.001, jitter_s=0.002)
        svc2.ping()
        for _ in range(3):
            with pytest.raises(ChaosError):
                svc2.ping()


@pytest.mark.chaos
def test_chaos_seeded_latency_is_deterministic():
    draws = []
    for _ in range(2):
        c = chaos(seed=42)
        draws.append([c.rng.uniform(0.0, 1.0) for _ in range(5)])
    assert draws[0] == draws[1]


def seeded_faults(p, seed: int) -> dict:
    """Call counts, raised calls and slept delays of stacked seeded
    faults over one object, with ``time.sleep`` recording instead of
    sleeping."""
    slept: list[float] = []
    mod = p.chaos
    mod._time = SimpleNamespace(sleep=slept.append, monotonic=time.monotonic, time=time.time)
    try:
        class Svc:
            def ping(self, i):
                return i

        svc = Svc()
        raised = []
        with mod.chaos(seed=seed) as c:
            c.inject_latency(svc, "ping", delay_s=0.01, jitter_s=0.05, limit=6)
            c.raise_on_nth_call(svc, "ping", n=4)
            c.raise_on_nth_call(svc, "ping", n=7, every=True)
            for i in range(9):
                try:
                    svc.ping(i)
                except mod.ChaosError:
                    raised.append(i)
            counts = c.call_count(svc, "ping")
            draws = [c.rng.random() for _ in range(3)]
        gen = mod.flaky_once(range(5), 3)
        flaky = []
        for _ in range(2):
            try:
                flaky.append(list(gen()))
            except mod.ChaosError:
                flaky.append("fault")
        fire = mod.chaos(seed=seed).firehose_source(None, 20, vocab=5, commit_every=7)
        rows = []
        fire.next = lambda **kw: rows.append(kw["word"])
        fire.commit = lambda: rows.append("|")
        fire.run()
        drill = mod.ClusterDrill("/nonexistent", seed=seed, processes=2)
        return {"slept": slept, "raised": raised, "count": counts, "draws": draws, "flaky": flaky, "rows": rows,
                "drill": (drill.kill_rank, drill.kill_epoch, drill.epoch_max_rows)}
    finally:
        mod._time = time


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_seeded_primitives_match_jax(seed):
    want = seeded_faults(package("jax"), seed)
    got = seeded_faults(package("port"), seed)
    assert got == want
    assert len(got["slept"]) == 5 and got["raised"] == [3, 6, 7, 8] and got["count"] == 9


@pytest.mark.chaos
def test_torn_append_leaves_committed_prefix_readable(tmp_path):
    impl = Backend.filesystem(tmp_path / "p")._impl
    impl.append("s", b"first")
    impl.append("s", b"second")
    with chaos() as c:
        c.torn_write(impl, on_nth=1, keep_fraction=0.5)
        with pytest.raises(ChaosError):
            impl.append("s", b"third-record-payload")
    assert impl.read_all("s") == [b"first", b"second"]
    impl.truncate("s", 2)
    impl.append("s", b"fourth")
    assert impl.read_all("s") == [b"first", b"second", b"fourth"]


@pytest.mark.chaos
def test_torn_write_during_run_recovers_on_restart(tmp_path):
    backend = Backend.filesystem(tmp_path / "snap")
    results1: dict = {}
    _build(lambda: iter(ROWS), results1)
    sched = Scheduler(G.engine_graph, autocommit_ms=10)
    attach_persistence(sched, Config.simple_config(backend))
    with chaos() as c:
        c.torn_write(backend._impl, on_nth=4, keep_fraction=0.3)
        sched.run()
    G.clear()
    results2: dict = {}
    _build(lambda: iter(ROWS), results2)
    _run(tmp_path)
    assert results2 == EXPECTED


@pytest.mark.chaos
def test_kill_mid_epoch_resume_produces_identical_tables(tmp_path):
    policy = ConnectorRecoveryPolicy(max_restarts=3, initial_delay_ms=5, jitter_ms=0, seed=0)
    results1: dict = {}
    _build(flaky_once(ROWS, 4), results1, policy=policy)
    sched = _run(tmp_path)
    assert results1 == EXPECTED
    stats = next(v for k, v in sched.connector_stats.items() if k.startswith("wsrc#"))
    assert stats["restarts"] == 1
    G.clear()
    rows2 = ROWS + [{"word": "a"}, {"word": "d"}]
    results2: dict = {}
    _build(lambda: iter(rows2), results2, policy=policy)
    _run(tmp_path)
    assert results2 == {"a": 4, "b": 2, "c": 1, "d": 1}


@pytest.mark.chaos
def test_crash_after_operator_snapshot_resumes_exactly(tmp_path):
    results1: dict = {}
    _build(lambda: iter(ROWS), results1)
    sched = Scheduler(G.engine_graph, autocommit_ms=5)
    attach_persistence(sched, Config.simple_config(
        Backend.filesystem(tmp_path / "snap"), persistence_mode=PersistenceMode.OPERATOR_PERSISTING,
        snapshot_interval_ms=0))
    with chaos() as c:
        c.crash_between_snapshot_and_commit(sched.persistence, on_nth=1)
        with pytest.raises(ChaosError):
            sched.run()
    sched.stop()  # "the process died": reap reader threads before run 2
    G.clear()
    results2: dict = {}
    _build(lambda: iter(ROWS), results2)
    _run(tmp_path, mode=PersistenceMode.OPERATOR_PERSISTING)
    assert results2 == EXPECTED


@pytest.mark.chaos
@pytest.mark.slow
def test_randomized_fault_points_always_exactly_once(tmp_path):
    rng = random.Random(2026)
    policy = ConnectorRecoveryPolicy(max_restarts=3, initial_delay_ms=5, jitter_ms=0, seed=0)
    for drill in range(5):
        G.clear()
        fail_at = rng.randrange(1, len(ROWS))
        results: dict = {}
        _build(flaky_once(ROWS, fail_at), results, policy=policy)
        Scheduler(G.engine_graph, autocommit_ms=10).run()
        assert results == EXPECTED, (drill, fail_at, results)


@pytest.mark.chaos
def test_asymmetric_partition_validates_mode_and_restores():
    from pathway_tpu_torch.engine.cluster import _PeerSender

    with pytest.raises(ValueError, match="drop.*delay|mode"):
        chaos(seed=0).asymmetric_partition(0, 1, mode="bogus")
    orig = _PeerSender._transmit
    with chaos(seed=0) as c:
        c.asymmetric_partition(0, 1, mode="drop")
        c.asymmetric_partition(1, 0, mode="delay", delay_s=0.0)
        assert _PeerSender._transmit is not orig
    assert _PeerSender._transmit is orig


@pytest.mark.chaos
def test_asymmetric_partition_scopes_one_direction():
    from pathway_tpu_torch.engine.cluster import _PeerSender

    sent = []

    class _Links:
        process_id = 1

    class _Sender:
        links = _Links()

        def __init__(self, peer):
            self.peer = peer

    orig = _PeerSender._transmit
    try:
        _PeerSender._transmit = lambda self, body, n: sent.append((self.links.process_id, self.peer))
        with chaos(seed=0) as c:
            c.asymmetric_partition(1, 0, mode="drop")
            wrapper = _PeerSender._transmit
            wrapper(_Sender(0), b"", 1)  # 1 -> 0: dropped
            wrapper(_Sender(2), b"", 1)  # 1 -> 2: delivered
        assert sent == [(1, 2)]
    finally:
        _PeerSender._transmit = orig


def proc_state(pid: int) -> str:
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


@pytest.mark.chaos
def test_pause_resume_stops_and_continues_process():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(20)"])
    try:
        with chaos(seed=1) as c:
            timer = c.pause_resume(proc.pid, pause_s=0.3)
            wait_for(lambda: proc_state(proc.pid) == "T", 5.0, "the SIGSTOP")
            timer.join(5.0)  # the SIGCONT timer fired
            wait_for(lambda: proc_state(proc.pid) in ("S", "R"), 5.0, "the SIGCONT")
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.chaos
def test_pause_resume_restore_fires_pending_sigcont():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(20)"])
    try:
        c = chaos(seed=2)
        with c:
            c.pause_resume(proc.pid, pause_s=60.0)
            wait_for(lambda: proc_state(proc.pid) == "T", 5.0, "the SIGSTOP")
        wait_for(lambda: proc_state(proc.pid) in ("S", "R"), 5.0, "the SIGCONT on restore")
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.chaos
def test_slow_peer_is_seeded_delay_wrapper():
    from pathway_tpu_torch.engine.cluster import _PeerSender

    orig = _PeerSender._transmit
    with chaos(seed=4) as c:
        c.slow_peer(0, delay_s=0.0, jitter_s=0.0)
        assert _PeerSender._transmit is not orig
    assert _PeerSender._transmit is orig


# ---------------------------------------------------------------------------
# tests/test_cluster_recovery.py against the port


def _run_drill(tmp_path, processes: int, seed: int, trace: bool = False) -> dict:
    report = ClusterDrill(str(tmp_path), seed=seed, processes=processes, trace=trace).run()
    assert report["restarts"] >= 1, report
    assert report["ok"], f"cluster did not recover: {report['failures']}"
    assert report["identical"], (report["baseline_output"], report["recovered_output"])
    assert report["recovery_seconds"], "no recovery time recorded"
    return report


@pytest.fixture(scope="module")
def traced_drills(tmp_path_factory) -> dict:
    """One traced run of each drill the flight-recorder cases read, shared
    with the cases that run the same drill at the same seed untraced in
    the JAX package's file: ``ClusterDrill`` at seed 3 and ``IndexDrill``
    at seed 7, two processes each (the drills' subprocesses dominate this
    file's time)."""
    cluster_dir = tmp_path_factory.mktemp("cluster_seed3")
    index_dir = tmp_path_factory.mktemp("index_seed7")
    index = IndexDrill(str(index_dir), seed=7, processes=2, trace=True)
    return {"cluster": (cluster_dir, _run_drill(cluster_dir, processes=2, seed=3, trace=True)),
            "index": (index_dir, index, index.run())}


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [3, 11])
def test_kill_random_worker_2proc_output_identical(tmp_path, seed, request):
    """The port's drill recovers to its own fault-free output, and for the
    same seed it writes the JAX drill's corpus, kills the same rank at the
    same epoch, and its recovered output is the JAX package's fault-free
    output byte for byte.  Seed 3 reads the traced run of
    ``traced_drills``."""
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    if seed == 3:
        port_dir, report = request.getfixturevalue("traced_drills")["cluster"]
    else:
        port_dir = tmp_path / "port"
        port_dir.mkdir()
        report = _run_drill(port_dir, processes=2, seed=seed)
    jdrill = package("jax").chaos.ClusterDrill(str(jax_dir), seed=seed, processes=2)
    assert (jdrill.kill_rank, jdrill.kill_epoch) == (report["kill_rank"], report["kill_epoch"])
    corpus = jdrill._write_corpus()
    assert open(corpus, "rb").read() == open(port_dir / "corpus.jsonl", "rb").read()
    prog, out = jdrill._write_program("baseline", corpus)
    assert jdrill._run_supervised(prog, {}).returncode == 0
    assert report["recovered_output"].encode() == jdrill.canonical_output(out)


@pytest.mark.chaos
@pytest.mark.slow
def test_kill_random_worker_4proc_output_identical(tmp_path):
    _run_drill(tmp_path, processes=4, seed=5)


@pytest.mark.chaos
def test_kill_worker_mid_merge_exactly_once(tmp_path, traced_drills):
    drill_dir, drill, report = traced_drills["index"]
    assert report["restarts"] >= 1, report
    assert report["returncode"] == 0, report["failures"]
    assert report["exactly_once"], report
    assert report["recall"] >= 0.95, report
    assert report["baseline_merges_total"] >= 1, report
    # the JAX drill over the same seed writes the same inputs and expects
    # the same index size
    jdrill = package("jax").chaos.IndexDrill(str(tmp_path / "jax"), seed=7, processes=2)
    os.makedirs(jdrill.workdir)
    jdocs, jqueries = jdrill._write_inputs()
    assert open(jdocs, "rb").read() == open(drill_dir / "docs.jsonl", "rb").read()
    assert open(jqueries, "rb").read() == open(drill_dir / "queries.jsonl", "rb").read()
    assert report["expected_size"] == len(jdrill._final) == drill.n_docs


def _link_pair(cluster, first_port: int, **kw):
    """Both ends of a 2-process TCP mesh, built in one process.  End 0
    blocks in its constructor waiting for end 1 to dial, so it goes on a
    thread."""
    out: dict = {}

    def build0() -> None:
        out[0] = cluster._ProcessLinks(0, 2, first_port, **kw)

    t = threading.Thread(target=build0, daemon=True)
    t.start()
    out[1] = cluster._ProcessLinks(1, 2, first_port, **kw)
    t.join(10.0)
    assert 0 in out, "mesh never completed"
    return out[0], out[1]


PORT = package("port")


@pytest.mark.chaos
def test_muted_peer_detected_within_liveness_timeout():
    liveness = 1.0
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.2, liveness_timeout_s=liveness)
    try:
        with chaos(seed=1) as c:
            c.drop_exchange_frames(after=0, process_id=1)
            t0 = time.monotonic()
            wait_for(lambda: links0._failed is not None, liveness + 3.0, "the muted peer's detection")
            detect_s = time.monotonic() - t0
            assert "silent" in links0._failed or "lost" in links0._failed
            assert detect_s < liveness + 2.0, f"detection took {detect_s:.1f}s"
            with pytest.raises(RuntimeError, match="cluster failure"):
                links0.recv_from_all(("never", 0))
            wait_for(lambda: links1._failed is not None, 5.0, "the peer's EOF")
    finally:
        links0.close()
        links1.close()


@pytest.mark.chaos
def test_idle_links_stay_alive_on_heartbeats():
    liveness = 0.8
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=liveness)
    try:
        quiet = threading.Event()
        quiet.wait(liveness * 2.5)  # the liveness window passes with heartbeats only
        assert links0._failed is None and links1._failed is None
        with links0.stats_lock:
            assert links0.stats["heartbeats_sent"] >= 1
    finally:
        links0.close()
        links1.close()


@pytest.mark.chaos
def test_close_is_bounded_with_live_peer():
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=5.0)
    links0.send_async(1, ("slot", 0), {"x": 1})  # traffic in flight
    t0 = time.monotonic()
    links0.close()
    links1.close()
    assert time.monotonic() - t0 < 8.0
    for links in (links0, links1):
        for sender in links._senders.values():
            assert not sender.is_alive()
        for reader in links._readers:
            reader.join(2.0)
            assert not reader.is_alive()


@pytest.mark.chaos
def test_isolate_peer_death_degrades_instead_of_failing():
    from pathway_tpu_torch.engine.cluster import PEER_DEAD

    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=1.0,
                                fail_policy="isolate")
    try:
        links1.close()
        wait_for(lambda: links0.peer_states().get(1) == PEER_DEAD, 8.0, "peer 1 declared dead")
        assert links0._failed is None
        member = links0.membership()[1]
        assert member["state"] == PEER_DEAD and member["reason"]
        assert links0.recv_from_all(("epoch", 0)) == {}
        assert links0.stats["peers_declared_dead"] == 1
    finally:
        links0.close()


@pytest.mark.chaos
def test_isolate_rejoin_with_bumped_incarnation():
    from pathway_tpu_torch.engine.cluster import PEER_ALIVE, PEER_DEAD, _ProcessLinks

    first_port = free_port_range(2)
    links0, links1 = _link_pair(PORT.cluster, first_port, heartbeat_s=0.1, liveness_timeout_s=1.0,
                                fail_policy="isolate")
    replacement = None
    try:
        links1.close()
        wait_for(lambda: links0.peer_states().get(1) == PEER_DEAD, 8.0, "peer 1 declared dead")
        deadline = time.monotonic() + 10.0
        while replacement is None:  # the dead listener's port frees within its accept timeout
            try:
                replacement = _ProcessLinks(1, 2, first_port, heartbeat_s=0.1, liveness_timeout_s=1.0,
                                            fail_policy="isolate", incarnation=1)
            except OSError:
                assert time.monotonic() < deadline, "replacement never bound its port"
                threading.Event().wait(0.1)
        wait_for(lambda: links0.peer_states().get(1) == PEER_ALIVE, 8.0, "the rejoin")
        assert links0.membership()[1]["incarnation"] == 1
        assert links0.stats["peers_rejoined"] == 1
        links0.send_async(1, ("x", 0), {"hello": 0})
        replacement.send_async(0, ("x", 0), {"hello": 1})
        assert links0.recv_from_all(("x", 0)) == {1: {"hello": 1}}
        assert replacement.recv_from_all(("x", 0)) == {0: {"hello": 0}}
    finally:
        links0.close()
        if replacement is not None:
            replacement.close()


@pytest.mark.chaos
def test_asymmetric_partition_is_detected_not_hung():
    from pathway_tpu_torch.engine.cluster import PEER_DEAD

    liveness = 1.0
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.2, liveness_timeout_s=liveness,
                                fail_policy="isolate")
    try:
        with chaos(seed=5) as c:
            c.asymmetric_partition(1, 0, mode="drop")
            t0 = time.monotonic()
            wait_for(lambda: links0.peer_states().get(1) == PEER_DEAD, liveness + 4.0, "the starved side's verdict")
            assert time.monotonic() - t0 < liveness + 2.0
            assert links0._failed is None and links1._failed is None
    finally:
        links0.close()
        links1.close()


@pytest.mark.chaos
def test_slow_peer_degrades_but_stays_alive():
    from pathway_tpu_torch.engine.cluster import PEER_DEAD

    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=2.0,
                                fail_policy="isolate")
    try:
        with chaos(seed=9) as c:
            c.slow_peer(1, delay_s=0.05, jitter_s=0.02)
            links1.send_async(0, ("y", 0), {"v": 42})
            assert links0.recv_from_all(("y", 0)) == {1: {"v": 42}}
            for i in range(5):  # several heartbeat intervals under the delay
                links1.send_async(0, ("z", i), {"v": i})
                assert links0.recv_from_all(("z", i)) == {1: {"v": i}}
            assert links0.peer_states().get(1) != PEER_DEAD
            assert links0._failed is None
    finally:
        links0.close()
        links1.close()


def _load_merged_trace(report: dict) -> list[dict]:
    trace_file = report["trace_file"]
    assert trace_file and os.path.exists(trace_file), report
    with open(trace_file) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.chaos
def test_kill_worker_flight_recorder_stitches_all_ranks(traced_drills):
    from pathway_tpu_torch.analysis import tracecrit

    _dir, report = traced_drills["cluster"]
    assert report["restarts"] >= 1 and report["ok"], report
    events = _load_merged_trace(report)
    assert {int(e.get("pid", -1)) for e in events} == {0, 1}
    assert report["kill_rank"] in {0, 1} and sorted(report["trace_ranks"]) == [0, 1]
    traces = tracecrit.group_traces(events)
    multi = [tid for tid, spans in traces.items() if len({s.get("pid") for s in spans}) >= 2]
    assert multi, "no trace stitched spans from more than one rank"
    conn = tracecrit.connected_traces(events)
    assert any(conn[tid] for tid in multi)
    exch = [e for e in events if e["name"] in ("pack", "unpack", "exchange_recv", "status_wait_peer")]
    assert exch and all({"src", "dst"} <= set(e["args"]) for e in exch)


@pytest.mark.chaos
def test_kill_worker_mid_merge_flight_recorder_dump(traced_drills):
    _dir, drill, report = traced_drills["index"]
    assert report["restarts"] >= 1 and report["returncode"] == 0, report
    events = _load_merged_trace(report)
    assert {int(e.get("pid", -1)) for e in events} == {0, 1}
    assert drill.kill_rank in {0, 1}
    assert all(e.get("ph") == "X" for e in events)
    assert all("span_id" in e.get("args", {}) for e in events)


# ---------------------------------------------------------------------------
# the overload drills of tests/test_overload.py, in both packages


def firehose_counts(p, tmp, monkeypatch, buffer_bytes, total, mode, seed, stall=None, slow=None) -> dict:
    pw = p.pw
    monkeypatch.setenv("PATHWAY_INGEST_BUFFER_BYTES", str(buffer_bytes))

    class CountSchema(pw.Schema):
        word: str
        payload: str

    pw.G.clear()
    out = tmp / f"{p.name}_out.jsonl"
    with p.chaos.chaos(seed=seed) as c:
        if stall is not None:
            c.stall_sink(*stall)
        if slow is not None:
            c.slow_consumer(0, factor=slow)
        src = c.firehose_source(None, total, vocab=8, payload_bytes=64, commit_every=50)
        t = pw.io.python.read(src, schema=CountSchema, on_overflow=mode)
        pw.io.jsonlines.write(t.groupby(t.word).reduce(t.word, n=pw.reducers.count()), str(out))
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        epochs = c.call_count(p.scheduler.Scheduler, "run_epoch") if slow is not None else None
    state: dict = {}
    for line in open(out):
        row = json.loads(line)
        if row["diff"] > 0:
            state[row["word"]] = row["n"]
        elif state.get(row["word"]) == row["n"]:
            del state[row["word"]]
    sched = pw.G.active_scheduler
    pw.G.clear()
    return {"counts": state, "totals": sched.ingest_credit.totals(), "pressure": sched.ingest_pressure(),
            "epochs": epochs}


def produced(seed: int, total: int) -> dict:
    """The words the seeded firehose produces (its per-source rng)."""
    rng = random.Random(random.Random(seed).randrange(2**31))
    out: dict = {}
    for _ in range(total):
        w = f"w{rng.randrange(8)}"
        out[w] = out.get(w, 0) + 1
    return out


@pytest.mark.chaos
def test_firehose_pause_is_lossless(tmp_path, monkeypatch):
    got = {name: firehose_counts(package(name), tmp_path, monkeypatch, 16384, 1200, "pause", 11) for name in BOTH}
    for name in BOTH:
        r = got[name]
        assert r["counts"] == produced(11, 1200), name
        assert r["totals"]["stalls_total"] >= 1 and r["totals"]["shed_rows_total"] == 0
        assert r["totals"]["buffered_bytes"] == 0
        assert "python" in r["pressure"]["sources"]
    assert got["port"]["counts"] == got["jax"]["counts"]


@pytest.mark.chaos
def test_firehose_shed_oldest_accounts_every_row(tmp_path, monkeypatch):
    for name in BOTH:
        r = firehose_counts(package(name), tmp_path, monkeypatch, 8192, 1500, "shed_oldest", 12, stall=(0.05, 8))
        arrived = sum(r["counts"].values())
        assert arrived + r["totals"]["shed_rows_total"] == 1500, name
        assert r["totals"]["shed_rows_total"] >= 1 and r["totals"]["stalls_total"] == 0, name


@pytest.mark.chaos
def test_stalled_sink_backpressures_to_source(tmp_path, monkeypatch):
    got = {name: firehose_counts(package(name), tmp_path, monkeypatch, 8192, 800, "pause", 13, stall=(0.1, 6))
           for name in BOTH}
    for name in BOTH:
        assert got[name]["counts"] == produced(13, 800), name
        assert got[name]["totals"]["stalls_total"] >= 1, name
    assert got["port"]["counts"] == got["jax"]["counts"]


@pytest.mark.chaos
def test_slow_consumer_rank_is_correct_and_complete(tmp_path, monkeypatch):
    got = {name: firehose_counts(package(name), tmp_path, monkeypatch, 1 << 26, 400, "pause", 14, slow=1.5)
           for name in BOTH}
    for name in BOTH:
        assert got[name]["counts"] == produced(14, 400), name
        assert got[name]["epochs"] >= 1
    assert got["port"]["counts"] == got["jax"]["counts"]


def _boxes(n_updates: int) -> list:
    return [[[(i, ("v" * 40,), 1) for i in range(n_updates)]]]


@pytest.mark.chaos
def test_exchange_credit_throttles_slow_but_alive_peer(monkeypatch):
    monkeypatch.setenv("PATHWAY_EXCHANGE_CREDIT_BYTES", "8192")
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=5.0)
    n_frames = 6
    try:
        sent = []

        def producer() -> None:
            for i in range(n_frames):
                links0.send_updates_async(1, ("s", i), _boxes(60))
                sent.append(i)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def stalled() -> bool:
            with links0.stats_lock:
                return links0.stats["credit_stalls"] >= 1

        wait_for(stalled, 10.0, "the producer to park on the credit window")
        assert len(sent) < n_frames
        pressure = links0.exchange_pressure()
        assert pressure["peers"][1]["state"] == "alive"
        assert pressure["peers"][1]["backlog_bytes"] <= 2 * 8192
        assert links0._failed is None
        for i in range(n_frames):
            assert 0 in links1.recv_from_all(("s", i))
        t.join(10.0)
        assert not t.is_alive() and len(sent) == n_frames
        with links0.stats_lock:
            assert links0.stats["credit_stall_ms"] > 0
    finally:
        links0.close()
        links1.close()


@pytest.mark.chaos
def test_exchange_credit_oversized_frame_passes_empty_window(monkeypatch):
    monkeypatch.setenv("PATHWAY_EXCHANGE_CREDIT_BYTES", "512")
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=5.0)
    try:
        links0.send_updates_async(1, ("big", 0), _boxes(200))
        assert 0 in links1.recv_from_all(("big", 0))
    finally:
        links0.close()
        links1.close()


@pytest.mark.chaos
def test_credit_waiter_released_by_link_failure(monkeypatch):
    monkeypatch.setenv("PATHWAY_EXCHANGE_CREDIT_BYTES", "4096")
    links0, links1 = _link_pair(PORT.cluster, free_port_range(2), heartbeat_s=0.1, liveness_timeout_s=5.0)
    try:
        released = threading.Event()

        def producer() -> None:
            for i in range(8):
                links0.send_updates_async(1, ("d", i), _boxes(60))
            released.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def stalled() -> bool:
            with links0.stats_lock:
                return links0.stats["credit_stalls"] >= 1

        wait_for(stalled, 10.0, "the producer to throttle")
        assert not released.is_set()
        links1.close()  # peer death: socket EOF fails the link
        assert released.wait(10.0)
        t.join(5.0)
    finally:
        links0.close()
        links1.close()


# ---------------------------------------------------------------------------
# tests/test_multiworker.py's kill-a-process restarts, in both packages


WORDCOUNT_PROGRAM = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.persistence import Backend, Config, PersistenceMode

    class S(pw.Schema):
        word: str

    t = pw.io.jsonlines.read({input!r}, schema=S, mode={mode!r})
    counts = t.groupby(t.word).reduce(t.word, n=pw.reducers.count())
    pw.io.jsonlines.write(counts, {output!r})
    pconf = Config.simple_config(Backend.filesystem({persist!r}), persistence_mode=PersistenceMode({persist_mode!r}))
    pw.run(autocommit_duration_ms=20, persistence_config=pconf)
""")


def spawn(pkg: str, d, mode: str, persist_mode: str, first_port: int) -> list:
    prog = d / f"prog_{mode}.py"
    prog.write_text(WORDCOUNT_PROGRAM.format(repo=REPO, pkg=pkg, input=str(d / "w.jsonl"), output=str(d / "out.jsonl"),
                                             mode=mode, persist=str(d / "snap"), persist_mode=persist_mode))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PATHWAY_THREADS="1", PATHWAY_PROCESSES="2", PATHWAY_FIRST_PORT=str(first_port))
    return [subprocess.Popen([sys.executable, str(prog)], env={**env, "PATHWAY_PROCESS_ID": str(pid)},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(2)]


def final_counts(path) -> dict:
    state: dict = {}
    if os.path.exists(path):
        for line in open(path):
            row = json.loads(line)
            if row["diff"] > 0:
                state[row["word"]] = row["n"]
            elif state.get(row["word"]) == row["n"]:
                del state[row["word"]]
    return state


def kill_restart(pkg: str, d, ws: list[str], kill_rank: int, persist_mode: str) -> dict:
    """A 2-process streaming wordcount, one process killed once output
    shows progress, then a static restart over the same storage; the
    final counts (merged over both runs under operator snapshots, whose
    restart re-fires only the groups it touches)."""
    d.mkdir()
    (d / "w.jsonl").write_text("\n".join(json.dumps({"word": w}) for w in ws))
    procs = spawn(pkg, d, "streaming", persist_mode, free_port_range(4))
    out = d / "out.jsonl"
    tick = threading.Event()
    wait_for(lambda: out.exists() and out.stat().st_size > 0, 120.0, "the first output", tick)
    tick.wait(0.3)  # one more commit interval: the log commits past the rows seen
    procs[kill_rank].send_signal(signal.SIGKILL)
    for p in procs:
        try:
            p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
    state = final_counts(out) if persist_mode == "operator_persisting" else {}
    out.unlink(missing_ok=True)
    procs = spawn(pkg, d, "static", persist_mode, free_port_range(4))
    for p in procs:
        _o, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    state.update(final_counts(out))
    return state


@pytest.mark.parametrize("kill_rank, persist_mode, n, vocab", [(1, "persisting", 400, 7),
                                                               (0, "operator_persisting", 300, 5)],
                         ids=["input_logs", "operator_snapshots"])
def test_process_kill_restart_recovers_like_jax(tmp_path, kill_rank, persist_mode, n, vocab):
    ws = [f"w{i}" for i in np.random.default_rng(n).integers(0, vocab, n)]
    want = {w: ws.count(w) for w in set(ws)}
    got = {name: kill_restart(pkg, tmp_path / name, ws, kill_rank, persist_mode)
           for name, pkg in (("jax", "pathway_tpu"), ("port", "pathway_tpu_torch"))}
    assert got["port"] == got["jax"] == want


# ---------------------------------------------------------------------------
# import hygiene of the drill programs


BLOCK = textwrap.dedent("""
    import runpy, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "pathway_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    runpy.run_path(sys.argv[1], run_name="__main__")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "pathway_tpu"))
    print("BAD=" + repr(bad))
    sys.exit(1 if bad else 0)
""")


def test_drill_programs_run_with_jax_blocked(tmp_path):
    """The ``ClusterDrill`` and ``IndexDrill`` programs the port writes
    run to their end in one process with ``jax`` and ``pathway_tpu``
    blocked, and write their sinks (and the index drill its stats)."""
    cdrill = ClusterDrill(str(tmp_path), seed=1, processes=1, rows=60)
    cprog, cout = cdrill._write_program("hygiene", cdrill._write_corpus())
    idrill = IndexDrill(str(tmp_path / "index"), seed=1, processes=1, n_docs=16, n_upserts=8, n_queries=4)
    os.makedirs(idrill.workdir)
    docs, queries = idrill._write_inputs()
    iprog, iout, idump = idrill._write_index_program("hygiene", docs, queries)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PATHWAY_PROCESSES", "PATHWAY_THREADS")}
    for prog in (cprog, iprog):
        out = subprocess.run([sys.executable, "-c", BLOCK, prog], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
        assert "BAD=[]" in out.stdout
    assert sum(json.loads(cdrill.canonical_output(cout)).values()) == 60
    assert json.load(open(idump))["size"] == 16
    assert len(idrill._final_answers(iout)) == 4
