"""Multi-worker execution: worker topology + pipelined collective exchange.

The reference scales out by running the identical dataflow on every worker
and exchanging records so that each stateful operator only keeps the rows
whose shard hash it owns (timely exchange channels: shared memory between
threads, TCP between processes — ``src/engine/dataflow.rs:1068-1072``,
``src/engine/dataflow/config.rs:67-120``).  This module provides the same
capability for the epoch-synchronous engine:

- :class:`Cluster` — ``threads × processes`` workers.  Worker ``w`` lives in
  process ``w // threads``.  Intra-process exchange is shared memory behind
  a barrier; inter-process exchange is a TCP full mesh on
  ``127.0.0.1:first_port+pid`` (reference ``CommunicationConfig::Cluster``).
- ``exchange(slot, outboxes)`` — all-to-all for one (node, port, epoch):
  every worker deposits one outbox per destination worker and receives the
  concatenation of what all workers sent it, merged in global worker order
  (deterministic, so N-worker runs produce the same output as 1-worker).
- ``round_statuses(round_no, obj)`` — the per-round epoch-cut consensus:
  every worker receives the list of all workers' statuses and applies the
  same pure decision function, so no asymmetric coordinator broadcast is
  needed.  This is the ONLY synchronization rendezvous on the steady-state
  path — data exchanges are mailbox waits on the frames themselves.
- ``allgather(slot, obj)`` — small-object gather for O(1) run-boundary
  agreements (replay length, snapshot presence, final error log).

Communication is PIPELINED rather than lock-step (the timely exchange
pusher/puller split, ``external/timely-dataflow/communication/``): a
dedicated sender thread per peer drains an outbound queue and coalesces
everything queued into one writev-style transmission (so an epoch's
per-operator frames and the round's status message share syscalls), and
the per-peer reader threads deserialize frames into slot-keyed mailboxes
as they arrive — serialization, transmission, and deserialization overlap
operator compute instead of bracketing it.  Update payloads travel in the
native binary codec (``pack_updates_into``/``unpack_updates``) appended
straight into a reusable transmission buffer; without the native module
they fall back to pickled plain tuples.

A worker failure is detected in bounded time rather than discovered by an
infinite ``recv``: every sender emits an empty heartbeat transmission when
its link has been idle for ``PATHWAY_CLUSTER_HEARTBEAT_S`` (riding the
existing framing — ``body_len=4, n_msgs=0`` decodes to zero deposits), and
every reader runs its socket with a finite timeout so it can check a
per-peer liveness deadline (``PATHWAY_CLUSTER_LIVENESS_TIMEOUT_S``).

What happens next is the **fail policy** (``fail_policy=`` /
``PATHWAY_CLUSTER_FAIL_POLICY``):

- ``"together"`` (default, the reference semantics — a worker panic
  aborts the cluster, ``dataflow.rs:5533-5536``): a peer silent past the
  deadline — or whose socket dies — fails the whole local mesh.
  ``_fail`` closes every socket so the failure propagates to all peers
  as EOFs within one io tick, and notifies the WakeupHub so parked
  workers observe it immediately.  Recovery is restart-from-persistence
  (``internals/resilience.ClusterSupervisor``).
- ``"isolate"`` (fail-domain isolation, ISSUE 13): membership is
  per-peer.  Every peer carries an ``alive``/``suspect``/``dead`` state
  — half a liveness window of silence marks it *suspect* (observable,
  still served), a full window marks it *dead*.  ``_fail_peer``
  quiesces only the links and exchange routes touching the dead peer:
  its sender stops, its socket closes, its undelivered frames are
  purged from the inbox, and the WakeupHub is notified so nobody blocks
  on it — ``recv_from_all`` then waits only on peers that are still
  alive.  Links are *incarnation-versioned*: the dial handshake carries
  ``(process_id, incarnation)``, a replacement rank rejoins by dialing
  every survivor with a higher incarnation (the persistent accept loop
  admits it, replacing the dead link), and frames from a stale
  incarnation are rejected instead of deposited — a zombie of the old
  rank cannot corrupt the rejoined mesh.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time as _time
from collections import deque
from typing import Any, Callable

from pathway_tpu_torch.engine.columnar import ColumnarBatch, extend_batch
from pathway_tpu_torch.internals import keys as K
from pathway_tpu_torch.internals import native as _native_mod
from pathway_tpu_torch.internals import tracing as _tracing

__all__ = [
    "Cluster",
    "WakeupHub",
    "stable_shard",
    "PEER_ALIVE",
    "PEER_SUSPECT",
    "PEER_DEAD",
]


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


#: per-peer membership states (isolate fail policy).  A peer is *suspect*
#: after half a liveness window of silence — still served, but hedgeable by
#: layers above — and *dead* after a full window or a socket error.
PEER_ALIVE = "alive"
PEER_SUSPECT = "suspect"
PEER_DEAD = "dead"


#: idle-link heartbeat period (seconds); each heartbeat is an empty
#: transmission that refreshes the peer's liveness clock
DEFAULT_HEARTBEAT_S = 1.0
#: a peer silent for this long is declared dead (seconds); must comfortably
#: exceed the heartbeat period so a single delayed frame never false-alarms
DEFAULT_LIVENESS_TIMEOUT_S = 10.0

#: a heartbeat is an EMPTY transmission: body_len=4, n_msgs=0.  The
#: receiver's existing decoder sees zero messages and deposits nothing —
#: the bytes themselves are the signal.
_HEARTBEAT = struct.pack("<QI", 4, 0)

#: default per-peer cap on unacknowledged exchange data bytes
#: (PATHWAY_EXCHANGE_CREDIT_BYTES; <= 0 disables flow control).  A
#: producer with this much data outstanding to one peer waits for a
#: credit grant instead of queueing more — a slow-but-alive peer
#: throttles its upstream instead of growing its mailbox without bound.
DEFAULT_EXCHANGE_CREDIT_BYTES = 64 << 20

#: magic slot for credit grants, piggybacked on ordinary transmissions
#: the way ``round_statuses`` piggybacks trace wires on "#tc": payload is
#: the receiver's cumulative consumed-bytes counter for this link.  The
#: reader intercepts it before the inbox — workers never see the slot.
_CREDIT_SLOT = "#cr"


def _est_boxes_bytes(boxes: list) -> int:
    """Cheap wire-size estimate of an update-box frame at enqueue time
    (exact sizes replace it once the sender thread encodes)."""
    n = 0
    for row in boxes:
        for box in row:
            n += len(box)
    return 96 + 56 * n


def _est_frame_boxes_bytes(boxes: list, native: Any) -> int:
    """Wire-size estimate for columnar boxes: frame segments are priced
    by their actual column-buffer footprint (fixed-width columns make
    this nearly exact), row segments by the per-update constant."""
    n = 96
    for row in boxes:
        for box in row:
            if isinstance(box, ColumnarBatch):
                for kind, seg in box.segments:
                    if kind == "f":
                        n += native.frame_nbytes(seg) + 32
                    else:
                        n += 56 * len(seg)
            else:
                n += 56 * len(box)
    return n


class WakeupHub:
    """Shared wakeup channel for the event-driven scheduler loops.

    Every producer of scheduler-relevant work notifies the hub: connector
    threads on enqueue, the exchange reader threads on frame arrival, any
    worker depositing into a collective (so siblings parked between rounds
    join the next round immediately), the GC pacer, and ``stop()``.  The
    consumer side is a *generation wait*: a worker snapshots ``seq()``
    BEFORE it drains its queues, and later parks in ``wait(seen, ...)`` —
    if anything was produced in between, the generation already moved and
    the wait returns immediately (no lost-wakeup window)."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._seq = 0

    def seq(self) -> int:
        with self._cv:
            return self._seq

    def notify(self) -> None:
        with self._cv:
            self._seq += 1
            self._cv.notify_all()

    def wait(self, seen: int, timeout: float) -> bool:
        """Park until the generation moves past ``seen`` (or timeout, the
        autocommit-bounded heartbeat); True iff a wakeup arrived."""
        with self._cv:
            if self._seq != seen:
                return True
            if timeout > 0.0:
                self._cv.wait(timeout)
            return self._seq != seen


def stable_shard(*values: Any) -> int:
    """Process-stable shard hash of a tuple of cell values (Python's
    builtin ``hash`` is salted per process, so it cannot route rows
    consistently across a TCP cluster; the 128-bit key hash can)."""
    try:
        return int(K.ref_scalar(*values))
    except Exception:
        return int(K.ref_scalar(repr(values)))


# message kinds inside a transmission (see _PeerSender._encode_msg):
#   transmission := [u64 body_len] body
#   body         := [u32 n_msgs] msg*
#   msg          := [u32 slot_len] slot_pickle [u8 kind] payload
_K_OBJ = 0      # [u64 len] pickle — statuses, gathers, control objects
_K_UPDATES = 1  # [u16 n_src][u16 n_dst] ([u64 len] packed_updates)* — binary
_K_PLAIN = 2    # [u64 len] pickle of plain (int_key, values, diff) boxes
#: columnar boxes: [u16 n_src][u16 n_dst], then per box [u16 n_segments]
#: and per segment [u8 tag (0=rows,1=frame)][u64 len][payload] — frame
#: segments ship the zero-copy column buffers (native frame codec) with
#: ONE string pool per transmission (TxPool on encode, the symmetric
#: RxPool on decode: identical insert order, so pool refs resolve by
#: index with no per-slot re-sending of repeated strings)
_K_FRAME = 3


class _PeerSender(threading.Thread):
    """Outbound half of one peer link: drains a queue of (slot, kind,
    payload) messages and ships everything queued at each wake as ONE
    length-prefixed transmission (coalesced framing — an epoch's operator
    frames and the round's status message share a single ``sendall``).
    Serialization happens here, off the worker threads, into a buffer
    whose capacity persists across epochs (no per-epoch allocation churn).
    """

    def __init__(self, peer: int, sock: socket.socket, links: "_ProcessLinks"):
        super().__init__(daemon=True, name=f"pw-cluster-send-{peer}")
        self.peer = peer
        self.sock = sock
        self.links = links
        #: which incarnation of this peer's link the sender serves; a
        #: replaced link's sender dying must not kill the replacement
        self.link_version = 0
        self._q: deque = deque()  # lk009: bounded by exchange credit accounting
        self._cv = threading.Condition()
        # NB: not "_stop" — that shadows threading.Thread._stop(),
        # which join() calls internally on CPython 3.10
        self._stopped = False
        #: close() sets this for a non-ALIVE peer: exit WITHOUT sending
        #: the backlog (bounded teardown must not drain into a stalled
        #: socket — sendall to a suspect peer can block for the full grace)
        self._drop = False
        #: grant nudge from the consuming side (see _ProcessLinks._kick)
        self._kicked = False
        #: estimated bytes of enqueued-but-not-yet-encoded data frames;
        #: part of the producer's outstanding-credit arithmetic
        self.queued_bytes = 0
        self._buf = bytearray()

    def enqueue(
        self, slot: Any, kind: int, payload: Any, est: int = 0
    ) -> None:
        with self._cv:
            self._q.append((slot, kind, payload))
            self.queued_bytes += est
            self._cv.notify()

    def stop(self, drop_backlog: bool = False) -> None:
        with self._cv:
            self._stopped = True
            if drop_backlog:
                self._drop = True
            self._cv.notify()

    def kick(self) -> None:
        """Wake the sender even with an empty mailbox, so a pending
        credit grant ships now instead of riding the next heartbeat."""
        with self._cv:
            self._kicked = True
            self._cv.notify()

    def run(self) -> None:
        links = self.links
        heartbeat_s = links.heartbeat_s
        try:
            while True:
                idle = False
                dropped = -1
                with self._cv:
                    while (
                        not self._q and not self._stopped and not self._kicked
                    ):
                        if not self._cv.wait(heartbeat_s):
                            idle = True
                            break
                    if self._stopped and self._drop:
                        # bounded teardown for a suspect/dead peer: the
                        # backlog is undeliverable — drop it instead of
                        # blocking close() behind a stalled sendall
                        dropped = len(self._q)
                        self._q.clear()
                        self.queued_bytes = 0
                    elif self._q:
                        idle = False
                    elif self._stopped:
                        return  # stopped and drained
                    self._kicked = False
                    items = list(self._q)
                    self._q.clear()
                    self.queued_bytes = 0
                if dropped >= 0:
                    if dropped:
                        with links.stats_lock:
                            links.stats["frames_dropped_on_close"] += dropped
                    return
                # credit grant piggyback: whatever we owe this peer rides
                # the transmission we were about to make anyway
                grant = links._take_grant(self.peer)
                if not items:
                    if grant is not None:
                        # kicked (or idle) with a pending grant: ship it
                        # alone; n_frames=0 keeps the data-transmission
                        # stats invariant (it is liveness+credit, not data)
                        body, _db = self._encode([(_CREDIT_SLOT, _K_OBJ, grant)])
                        self._transmit(body, 0)
                    elif idle:
                        # link idle past the heartbeat period: ship an
                        # empty transmission so the peer's liveness clock
                        # advances
                        self._transmit(_HEARTBEAT, 0)
                    continue
                if grant is not None:
                    items.append((_CREDIT_SLOT, _K_OBJ, grant))
                # thread_time, not perf_counter: wall time in a helper
                # thread mostly measures GIL waits while the workers run;
                # this thread's own CPU is the compute it displaces
                t0 = _time.thread_time()
                t0_ns = _time.monotonic_ns()
                body, data_bytes = self._encode(items)
                t1 = _time.thread_time()
                with links.stats_lock:
                    links.stats["pack_ms"] += (t1 - t0) * 1e3
                _tracing.record_span(
                    "pack", t0_ns, _time.monotonic_ns(),
                    args={"src": links.process_id, "dst": self.peer},
                )
                if data_bytes:
                    # account BEFORE the send: outstanding must never
                    # under-count while bytes are on the wire
                    links._note_data_sent(self.peer, data_bytes)
                self._transmit(body, len(items))
        except Exception as e:  # socket OR encode failure: fail loudly
            links._fail_peer(
                self.peer,
                self.link_version,
                f"send link to process {self.peer} lost: {e!r}",
            )

    def _transmit(self, body: bytes | bytearray, n_frames: int) -> None:
        """Ship one already-encoded transmission (``n_frames == 0`` marks a
        heartbeat).  The single egress point for this link — fault
        injection (``testing/chaos``) patches here to delay or drop frames,
        and a dropped frame mutes heartbeats too, so a muted peer becomes
        *detectably* dead instead of silently lossy."""
        links = self.links
        t0 = _time.thread_time()
        self.sock.sendall(body)
        t1 = _time.thread_time()
        with links.stats_lock:
            st = links.stats
            if n_frames:
                # heartbeats are deliberately NOT "transmissions": that
                # stat means coalesced *data* sendalls, and its invariant
                # frames_sent >= transmissions must survive idle links
                st["transmissions"] += 1
                st["frames_sent"] += n_frames
                st["frames_coalesced"] += n_frames - 1
            else:
                st["heartbeats_sent"] += 1
            st["bytes_sent"] += len(body)
            st["send_ms"] += (t1 - t0) * 1e3

    # ------------------------------------------------------------------
    def _encode(self, items: list) -> tuple[bytearray, int]:
        """Encode one transmission; also returns the wire bytes of the
        DATA (update-box) messages in it — the unit the credit protocol
        accounts in on both sides (the receiver measures the identical
        spans while decoding)."""
        native = _native_mod.load()
        txpool = None
        if native is not None and any(k == _K_FRAME for _s, k, _p in items):
            # one string pool per transmission: frames encoded in msg
            # order, so the receiver's RxPool (same order) resolves pool
            # refs by index — repeated strings cross the wire once
            txpool = native.frame_txpool_new()
        try:
            return self._encode_into(items, native, txpool)
        except Exception:
            if txpool is None:
                raise
            # a frame msg failed mid-encode: the shared pool may hold
            # inserts whose bytes never shipped, so pool refs from later
            # frames would skew on the receiver — rebuild the WHOLE
            # transmission on the row path (no pool, self-contained msgs)
            items = [
                (
                    slot,
                    _K_UPDATES,
                    [
                        [
                            box.to_list()
                            if isinstance(box, ColumnarBatch)
                            else box
                            for box in row
                        ]
                        for row in payload
                    ],
                )
                if kind == _K_FRAME
                else (slot, kind, payload)
                for slot, kind, payload in items
            ]
            return self._encode_into(items, native, None)

    def _encode_into(
        self, items: list, native: Any, txpool: Any
    ) -> tuple[bytearray, int]:
        buf = self._buf
        del buf[:]  # reset length, keep capacity across epochs
        buf += b"\x00" * 12  # u64 body_len + u32 n_msgs, patched below
        data_bytes = 0
        for slot, kind, payload in items:
            before = len(buf)
            self._encode_msg(buf, slot, kind, payload, native, txpool)
            if kind in (_K_UPDATES, _K_FRAME):
                data_bytes += len(buf) - before
        struct.pack_into("<QI", buf, 0, len(buf) - 8, len(items))
        if txpool is not None:
            hits, misses = native.frame_txpool_stats(txpool)
            with self.links.stats_lock:
                st = self.links.stats
                st["strpool_hits"] += hits
                st["strpool_misses"] += misses
        return buf, data_bytes

    @staticmethod
    def _encode_msg(
        buf: bytearray,
        slot: Any,
        kind: int,
        payload: Any,
        native: Any,
        txpool: Any = None,
    ) -> None:
        slot_data = pickle.dumps(slot, protocol=pickle.HIGHEST_PROTOCOL)
        buf += struct.pack("<I", len(slot_data))
        buf += slot_data
        if kind == _K_OBJ:
            data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
            buf += struct.pack("<BQ", _K_OBJ, len(data))
            buf += data
            return
        if kind == _K_FRAME and native is not None:
            # columnar boxes: frame segments append their column buffers
            # verbatim (no per-row boxing), row segments ride the update
            # codec.  A failure here must NOT fall back per-msg — the
            # transmission's shared string pool may already hold inserts
            # from the torn msg — so it propagates and _encode rebuilds
            # the whole transmission on the row path.
            n_src = len(payload)
            n_dst = len(payload[0]) if n_src else 0
            buf += struct.pack("<BHH", _K_FRAME, n_src, n_dst)
            pack_rows = native.pack_updates_into
            pack_frame = native.frame_pack_into
            for row in payload:
                for box in row:
                    segs = (
                        box.segments
                        if isinstance(box, ColumnarBatch)
                        else ([("r", box)] if box else [])
                    )
                    buf += struct.pack("<H", len(segs))
                    for tag, seg in segs:
                        buf += b"\x01" if tag == "f" else b"\x00"
                        at = len(buf)
                        buf += b"\x00" * 8
                        if tag == "f":
                            n = pack_frame(seg, buf, txpool)
                        else:
                            n = pack_rows(seg, buf)
                        struct.pack_into("<Q", buf, at, n)
            return
        if kind == _K_FRAME:
            payload = [
                [
                    box.to_list() if isinstance(box, ColumnarBatch) else box
                    for box in row
                ]
                for row in payload
            ]
        # update boxes: payload[src_tid][dst_tid] is a list of Updates.
        # Binary frames append straight into the transmission buffer (one
        # C++ pass per box, length patched after the fact); a box the
        # codec rejects rolls the whole msg back to the pickled fallback
        # so the peer never sees a torn frame.
        mark = len(buf)
        if native is not None:
            try:
                n_src = len(payload)
                n_dst = len(payload[0]) if n_src else 0
                buf += struct.pack("<BHH", _K_UPDATES, n_src, n_dst)
                pack_into = getattr(native, "pack_updates_into", None)
                for row in payload:
                    for box in row:
                        at = len(buf)
                        buf += b"\x00" * 8
                        if pack_into is not None:
                            n = pack_into(box, buf)
                        else:
                            data = native.pack_updates(box)
                            buf += data
                            n = len(data)
                        struct.pack_into("<Q", buf, at, n)
                return
            except Exception:
                del buf[mark:]
        plain = [
            [[(int(u[0]), u[1], u[2]) for u in box] for box in row]
            for row in payload
        ]
        data = pickle.dumps(plain, protocol=pickle.HIGHEST_PROTOCOL)
        buf += struct.pack("<BQ", _K_PLAIN, len(data))
        buf += data


class _ProcessLinks:
    """TCP full mesh between processes.  Process p listens on
    ``first_port + p``; every pair is connected once (higher pid dials
    lower pid).  Each link runs a sender thread (outbound queue, coalesced
    transmissions) and a reader thread that decodes arriving frames into a
    slot-keyed mailbox — ``recv_from_all`` is a pure mailbox wait."""

    _CONNECT_TIMEOUT_S = 30.0

    def __init__(
        self,
        process_id: int,
        n_processes: int,
        first_port: int,
        hub: "WakeupHub | None" = None,
        heartbeat_s: float | None = None,
        liveness_timeout_s: float | None = None,
        fail_policy: str | None = None,
        incarnation: int | None = None,
    ):
        self.process_id = process_id
        self.n_processes = n_processes
        self._hub = hub
        self.fail_policy = fail_policy or os.environ.get(
            "PATHWAY_CLUSTER_FAIL_POLICY", ""
        ) or "together"
        if self.fail_policy not in ("together", "isolate"):
            raise ValueError(
                f"fail_policy must be 'together' or 'isolate', "
                f"got {self.fail_policy!r}"
            )
        #: this process's incarnation: 0 at first boot, bumped by the
        #: supervisor for each per-rank replacement (the dial handshake
        #: carries it so survivors can tell a rejoin from a zombie)
        self.incarnation = (
            incarnation
            if incarnation is not None
            else _env_int("PATHWAY_CLUSTER_INCARNATION", 0)
        )
        self.heartbeat_s = (
            heartbeat_s
            if heartbeat_s is not None
            else _env_float("PATHWAY_CLUSTER_HEARTBEAT_S", DEFAULT_HEARTBEAT_S)
        )
        self.liveness_timeout_s = (
            liveness_timeout_s
            if liveness_timeout_s is not None
            else _env_float(
                "PATHWAY_CLUSTER_LIVENESS_TIMEOUT_S", DEFAULT_LIVENESS_TIMEOUT_S
            )
        )
        #: finite socket timeout for the reader loops — short enough that
        #: a reader re-checks its peer's liveness deadline several times
        #: per timeout window, long enough to stay off the hot path
        self._io_tick_s = max(0.01, min(1.0, self.liveness_timeout_s / 4.0))
        self._socks: dict[int, socket.socket] = {}
        self._senders: dict[int, _PeerSender] = {}
        self._readers: list[threading.Thread] = []
        self._last_seen: dict[int, float] = {}
        self._inbox: dict[Any, dict[int, Any]] = {}
        #: per-(slot, peer) deposit timestamps (monotonic ns), recorded by
        #: the reader threads and consumed by the collectives to split the
        #: aggregate "status-wait" number into per-peer wait spans
        self._arrival_ns: dict[Any, dict[int, int]] = {}
        self._cv = threading.Condition()
        self._failed: str | None = None
        self._closed = False
        self._running = False  # mesh built: admissions start links inline
        #: membership tables (isolate policy; benign defaults otherwise)
        self._peer_state: dict[int, str] = {}
        self._peer_incarnation: dict[int, int] = {}
        self._dead_reason: dict[int, str] = {}
        #: local link version per peer, bumped each time the peer's socket
        #: is replaced — readers/senders tag themselves with it so frames
        #: and errors from a superseded link are rejected, not believed
        self._link_version: dict[int, int] = {}
        #: per-peer cap on unacknowledged outbound data bytes (credit
        #: flow control); <= 0 disables the producer wait entirely
        self.credit_bytes = _env_int(
            "PATHWAY_EXCHANGE_CREDIT_BYTES", DEFAULT_EXCHANGE_CREDIT_BYTES
        )
        #: credit ledgers, all under _cv.  Outbound: wire data bytes sent
        #: to peer vs. the peer's cumulative consumed-grant.  Inbound:
        #: data bytes we consumed from peer vs. the grant value already
        #: shipped back.  _inbox_bytes mirrors _inbox with wire sizes so
        #: consumption is measured when a worker POPS the payload, not
        #: when the reader deposits it — a slow worker, not a fast
        #: socket, is what must throttle the remote producer.
        self._data_sent: dict[int, int] = {}
        self._data_granted: dict[int, int] = {}
        self._consumed_from: dict[int, int] = {}
        self._granted_sent: dict[int, int] = {}
        self._inbox_bytes: dict[Any, dict[int, int]] = {}
        self.stats: dict[str, Any] = {
            "transmissions": 0,
            "frames_sent": 0,
            "frames_coalesced": 0,
            "heartbeats_sent": 0,
            "bytes_sent": 0,
            "bytes_recv": 0,
            "stale_frames_dropped": 0,
            "peers_declared_dead": 0,
            "peers_rejoined": 0,
            "credit_stalls": 0,
            "credit_stall_ms": 0.0,
            "frames_dropped_on_close": 0,
            "pack_ms": 0.0,
            "send_ms": 0.0,
            "unpack_ms": 0.0,
            # per-transmission string-pool effectiveness of the columnar
            # wire: a hit is a string that crossed as a u32 pool ref
            "strpool_hits": 0,
            "strpool_misses": 0,
        }
        self.stats_lock = threading.Lock()

        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", first_port + process_id))
        listener.listen(n_processes)
        self._listener = listener

        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(listener,), daemon=True,
            name=f"pw-cluster-accept-{process_id}",
        )
        self._accept_thread.start()
        if self.incarnation == 0:
            # first boot: dial every lower pid (it is already listening or
            # will be soon); higher pids dial in via the accept loop
            dial_targets = range(process_id)
        else:
            # rejoin (per-rank replacement): every survivor's mesh is
            # already built, so nobody will dial us — dial them ALL, with
            # our incarnation in the handshake so they admit the rejoin
            dial_targets = (
                p for p in range(n_processes) if p != process_id
            )
        for peer in dial_targets:
            self._admit_peer(peer, self._dial(peer, first_port), 0)
        deadline = _time.monotonic() + self._CONNECT_TIMEOUT_S
        with self._cv:
            while len(self._socks) < n_processes - 1:
                left = deadline - _time.monotonic()
                if left <= 0.0:
                    break
                self._cv.wait(min(left, 0.2))
            complete = len(self._socks) == n_processes - 1
        if not complete:
            raise RuntimeError(
                f"process {process_id}: cluster mesh incomplete "
                f"({len(self._socks)}/{n_processes - 1} peers)"
            )
        now = _time.monotonic()
        with self._cv:
            self._running = True
            pairs = list(self._socks.items())
            for peer, _sock in pairs:
                self._last_seen[peer] = now
        for peer, sock in pairs:
            self._start_link(peer, sock)

    def _dial(self, peer: int, first_port: int) -> socket.socket:
        deadline = _time.monotonic() + self._CONNECT_TIMEOUT_S
        while True:
            try:
                sock = socket.create_connection(
                    ("127.0.0.1", first_port + peer), timeout=5.0
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(
                    struct.pack("<II", self.process_id, self.incarnation)
                )
                return sock
            except OSError:
                if _time.monotonic() > deadline:
                    raise RuntimeError(
                        f"process {self.process_id}: cannot reach peer {peer}"
                    )
                _time.sleep(0.05)

    def _accept_loop(self, listener: socket.socket) -> None:
        """Persistent accept loop: admits the initial higher-pid dials AND
        (isolate policy) any later rejoin from a replacement rank — the
        listener stays open for the lifetime of the links."""
        listener.settimeout(1.0)
        while not self._closed:
            try:
                sock, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: teardown
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(self._CONNECT_TIMEOUT_S)  # bound handshake
                peer, peer_inc = struct.unpack(
                    "<II", self._recv_exact(sock, 8)
                )
            except (OSError, ConnectionError, struct.error):
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            self._admit_peer(peer, sock, peer_inc)

    def _admit_peer(
        self, peer: int, sock: socket.socket, peer_inc: int
    ) -> None:
        """Record (or replace) the link to ``peer``.  Admission control:
        while a live link stands, a dial with an incarnation <= the known
        one is a duplicate or a zombie of the dead rank — refused.  A
        rejoin (dead peer, or strictly higher incarnation) replaces the
        link: the old socket closes, the old sender stops, the dead
        incarnation's undelivered frames are purged, and — once the mesh
        is running — a fresh sender/reader pair starts immediately."""
        old_sock = old_sender = None
        with self._cv:
            if self._closed:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            known_inc = self._peer_incarnation.get(peer)
            state = self._peer_state.get(peer)
            if (
                peer in self._socks
                and state != PEER_DEAD
                and known_inc is not None
                and peer_inc <= known_inc
            ):
                try:
                    sock.close()
                except OSError:
                    pass
                return
            rejoin = state == PEER_DEAD
            old_sock = self._socks.pop(peer, None)
            old_sender = self._senders.pop(peer, None)
            # quiesce the dead incarnation's routes: its undelivered
            # frames must not satisfy a wait meant for the replacement
            for deposits in self._inbox.values():
                deposits.pop(peer, None)
            self._reset_credit_locked(peer)
            self._link_version[peer] = self._link_version.get(peer, -1) + 1
            self._peer_incarnation[peer] = peer_inc
            self._peer_state[peer] = PEER_ALIVE
            self._dead_reason.pop(peer, None)
            self._socks[peer] = sock
            self._last_seen[peer] = _time.monotonic()
            running = self._running
            self._cv.notify_all()
        if rejoin:
            with self.stats_lock:
                self.stats["peers_rejoined"] += 1
        if old_sender is not None:
            old_sender.stop()
        if old_sock is not None:
            try:
                old_sock.close()
            except OSError:
                pass
        if running:
            self._start_link(peer, sock)
        if self._hub is not None:
            self._hub.notify()

    def _start_link(self, peer: int, sock: socket.socket) -> None:
        version = self._link_version.get(peer, 0)
        sender = _PeerSender(peer, sock, self)
        sender.link_version = version
        self._senders[peer] = sender
        sender.start()
        reader = threading.Thread(
            target=self._read_loop,
            args=(peer, sock, version),
            daemon=True,
            name=f"pw-cluster-recv-{peer}",
        )
        self._readers.append(reader)
        reader.start()

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    def _recv_live(self, peer: int, sock: socket.socket, view: memoryview) -> None:
        """Exact read that tolerates the finite socket timeout: partial
        progress is kept across timeouts, and each timeout re-checks the
        peer's liveness deadline — a peer silent past it (no data, no
        heartbeats) is declared dead in bounded time."""
        got = 0
        n = len(view)
        while got < n:
            try:
                r = sock.recv_into(view[got:])
            except socket.timeout:
                silent_s = _time.monotonic() - self._last_seen[peer]
                if silent_s > self.liveness_timeout_s:
                    raise ConnectionError(
                        f"peer process {peer} silent for {silent_s:.1f}s "
                        f"(liveness timeout {self.liveness_timeout_s:.1f}s)"
                    ) from None
                if (
                    self.fail_policy == "isolate"
                    and silent_s > self.liveness_timeout_s / 2.0
                    and self._peer_state.get(peer) == PEER_ALIVE
                ):
                    # half a window of silence: observably *suspect* —
                    # layers above may hedge around it before it is dead
                    with self._cv:
                        if self._peer_state.get(peer) == PEER_ALIVE:
                            self._peer_state[peer] = PEER_SUSPECT
                            self._cv.notify_all()
                continue
            if not r:
                raise ConnectionError("peer closed")
            got += r
            self._last_seen[peer] = _time.monotonic()
            if self._peer_state.get(peer) == PEER_SUSPECT:
                with self._cv:
                    if self._peer_state.get(peer) == PEER_SUSPECT:
                        self._peer_state[peer] = PEER_ALIVE
                        self._cv.notify_all()

    def _fail(self, msg: str) -> None:
        with self._cv:
            if self._failed is None:
                self._failed = msg
            self._cv.notify_all()
        # turn a one-sided failure into a whole-mesh one: closing our
        # sockets EOFs every peer's reader within one io tick, so the
        # cluster fails together instead of timing out link by link
        for sock in list(self._socks.values()):
            try:
                sock.close()
            except OSError:
                pass
        if self._hub is not None:
            self._hub.notify()
        # liveness trip: flush the flight recorder while the rings still
        # hold the rounds leading up to the failure (no-op without a
        # spool dir; never raises)
        _tracing.flush("liveness")

    def _fail_peer(self, peer: int, link_version: int, msg: str) -> None:
        """Single-peer failure path.  Under the ``together`` policy this
        is :meth:`_fail` (legacy semantics).  Under ``isolate`` only the
        fail domain of ``peer`` is quiesced: mark it dead, purge its
        undelivered frames, stop its sender, close its socket, and wake
        every waiter — the rest of the mesh keeps running."""
        if self.fail_policy != "isolate":
            self._fail(msg)
            return
        with self._cv:
            if self._closed:
                return
            if self._link_version.get(peer) != link_version:
                return  # a superseded link dying is not news
            if self._peer_state.get(peer) == PEER_DEAD:
                return
            self._peer_state[peer] = PEER_DEAD
            self._dead_reason[peer] = msg
            # quiesce the routes touching this peer: its undelivered
            # frames must never satisfy a later wait
            for deposits in self._inbox.values():
                deposits.pop(peer, None)
            for arrivals in self._arrival_ns.values():
                arrivals.pop(peer, None)
            # release producers parked on this peer's credit: a dead
            # peer's outstanding bytes are void (rejoin restarts at zero)
            self._reset_credit_locked(peer)
            sender = self._senders.pop(peer, None)
            sock = self._socks.pop(peer, None)
            self._cv.notify_all()
        with self.stats_lock:
            self.stats["peers_declared_dead"] += 1
        if sender is not None:
            # the backlog is undeliverable — drop, don't drain
            sender.stop(drop_backlog=True)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if self._hub is not None:
            self._hub.notify()
        _tracing.flush("liveness")

    def _read_loop(
        self, peer: int, sock: socket.socket, link_version: int = 0
    ) -> None:
        native = _native_mod.load()
        header = bytearray(8)
        header_view = memoryview(header)
        body = bytearray(1 << 16)  # grows to the largest transmission seen
        try:
            # finite timeout: the reader must wake to check the liveness
            # deadline even when the peer sends nothing at all
            sock.settimeout(self._io_tick_s)
            while True:
                self._recv_live(peer, sock, header_view)
                (body_len,) = struct.unpack_from("<Q", header, 0)
                if body_len > len(body):
                    body = bytearray(body_len)
                mv = memoryview(body)[:body_len]
                self._recv_live(peer, sock, mv)
                t0 = _time.thread_time()  # CPU displaced, not GIL waits
                t0_ns = _time.monotonic_ns()
                deposits = self._decode(mv, native)
                dt = (_time.thread_time() - t0) * 1e3
                now_ns = _time.monotonic_ns()
                with self.stats_lock:
                    self.stats["bytes_recv"] += 8 + body_len
                    self.stats["unpack_ms"] += dt
                # credit grants are link-control, not data: apply them
                # (monotonic max — grants are cumulative counters) and
                # keep them out of the inbox
                grant = None
                data = []
                for slot, payload, nbytes in deposits:
                    if slot == _CREDIT_SLOT:
                        if grant is None or payload > grant:
                            grant = payload
                    else:
                        data.append((slot, payload, nbytes))
                if grant is not None:
                    with self._cv:
                        if grant > self._data_granted.get(peer, 0):
                            self._data_granted[peer] = grant
                            # wake producers parked in _wait_for_credit
                            self._cv.notify_all()
                if not data:
                    continue  # heartbeat/grant: bytes already did their job
                _tracing.record_span(
                    "unpack", t0_ns, now_ns,
                    args={"src": peer, "dst": self.process_id},
                )
                with self._cv:
                    if (
                        self._link_version.get(peer, 0) != link_version
                        or self._peer_state.get(peer) == PEER_DEAD
                    ):
                        # generation-versioned rejection: frames from a
                        # superseded or dead incarnation are dropped, not
                        # deposited — a zombie cannot corrupt the mesh
                        with self.stats_lock:
                            self.stats["stale_frames_dropped"] += len(data)
                        return
                    box = self._inbox
                    arrivals = self._arrival_ns
                    for slot, payload, nbytes in data:
                        box.setdefault(slot, {})[peer] = payload
                        arrivals.setdefault(slot, {})[peer] = now_ns
                        if nbytes:
                            self._inbox_bytes.setdefault(slot, {})[
                                peer
                            ] = nbytes
                    self._cv.notify_all()
                if self._hub is not None:
                    # frame arrival is a scheduler-relevant event: wake any
                    # worker parked between rounds so it joins this round
                    self._hub.notify()
        except RuntimeError as e:
            # decode-configuration failure (e.g. native module missing in
            # THIS process): not a peer's fault — fail the whole mesh
            self._fail(str(e))
        except Exception as e:  # socket failure: fail this peer's domain
            self._fail_peer(
                peer, link_version, f"link to process {peer} lost: {e!r}"
            )

    @staticmethod
    def _decode(mv: memoryview, native: Any) -> list:
        """Decode one transmission into [(slot, payload, nbytes)]; update
        payloads come out as fully-built ``Update`` lists (deserialization
        happens here on the reader thread, overlapping worker compute).
        ``nbytes`` is the wire size of DATA messages (update boxes, plain
        or binary) and 0 for control objects — measured over the same
        byte spans the sender charged against the peer's credit, so the
        two ledgers agree exactly."""
        (n_msgs,) = struct.unpack_from("<I", mv, 0)
        off = 4
        out = []
        rxpool = None  # per-transmission, mirrors the sender's TxPool
        for _ in range(n_msgs):
            msg_start = off
            (slot_len,) = struct.unpack_from("<I", mv, off)
            off += 4
            slot = pickle.loads(mv[off : off + slot_len])
            off += slot_len
            kind = mv[off]
            off += 1
            if kind == _K_FRAME:
                if native is None:
                    raise RuntimeError(
                        "cluster exchange: peer sent columnar frames but "
                        "the native module is unavailable in this process"
                    )
                if rxpool is None:
                    rxpool = native.frame_rxpool_new()
                n_src, n_dst = struct.unpack_from("<HH", mv, off)
                off += 4
                boxes = []
                for _s in range(n_src):
                    row = []
                    for _d in range(n_dst):
                        (n_segs,) = struct.unpack_from("<H", mv, off)
                        off += 2
                        parts = []
                        any_frame = False
                        for _g in range(n_segs):
                            tag = mv[off]
                            off += 1
                            (blen,) = struct.unpack_from("<Q", mv, off)
                            off += 8
                            span = mv[off : off + blen]
                            off += blen
                            if tag == 1:
                                any_frame = True
                                parts.append(
                                    ("f", native.frame_unpack(span, rxpool))
                                )
                            else:
                                parts.append(
                                    ("r", native.unpack_updates(span))
                                )
                        if not any_frame:
                            # pure row box: hand workers the plain list
                            # they have always received
                            rows_only: list = (
                                parts[0][1] if len(parts) == 1 else []
                            )
                            if len(parts) > 1:
                                for _t, p in parts:
                                    rows_only.extend(p)
                            row.append(rows_only)
                        else:
                            cb = ColumnarBatch()
                            for t, p in parts:
                                if t == "f":
                                    cb.append_frame(p)
                                else:
                                    cb.extend(p)
                            row.append(cb)
                    boxes.append(row)
                out.append((slot, boxes, off - msg_start))
                continue
            if kind == _K_UPDATES:
                if native is None:
                    # peer packed binary frames we cannot parse (native
                    # load failed only on THIS process, e.g. a corrupted
                    # build cache): fail loudly rather than guess
                    raise RuntimeError(
                        "cluster exchange: peer sent binary frames but "
                        "the native module is unavailable in this process"
                    )
                n_src, n_dst = struct.unpack_from("<HH", mv, off)
                off += 4
                unpack = native.unpack_updates
                boxes = []
                for _s in range(n_src):
                    row = []
                    for _d in range(n_dst):
                        (blen,) = struct.unpack_from("<Q", mv, off)
                        off += 8
                        row.append(unpack(mv[off : off + blen]))
                        off += blen
                    boxes.append(row)
                out.append((slot, boxes, off - msg_start))
                continue
            (dlen,) = struct.unpack_from("<Q", mv, off)
            off += 8
            obj = pickle.loads(mv[off : off + dlen])
            off += dlen
            if kind == _K_PLAIN:
                from pathway_tpu_torch.engine.stream import Update
                from pathway_tpu_torch.internals.keys import Pointer

                obj = [
                    [
                        [Update(Pointer(k), v, d) for k, v, d in box]
                        for box in row
                    ]
                    for row in obj
                ]
            out.append(
                (slot, obj, (off - msg_start) if kind == _K_PLAIN else 0)
            )
        return out

    # ------------------------------------------------------------------
    # credit flow control (exchange data only; control frames are exempt
    # so collectives can never deadlock on a full data window)

    def _reset_credit_locked(self, peer: int) -> None:
        """Void a peer's credit ledgers (link replaced or declared dead);
        caller holds ``_cv`` — its notify_all releases parked producers."""
        self._data_sent.pop(peer, None)
        self._data_granted.pop(peer, None)
        self._consumed_from.pop(peer, None)
        self._granted_sent.pop(peer, None)
        for sizes in self._inbox_bytes.values():
            sizes.pop(peer, None)

    def _note_data_sent(self, peer: int, nbytes: int) -> None:
        with self._cv:
            self._data_sent[peer] = self._data_sent.get(peer, 0) + nbytes

    def _take_grant(self, peer: int) -> int | None:
        """Grant value owed to ``peer`` (our cumulative consumed-bytes
        counter), or None if the last sent grant is still current.  The
        caller (its sender thread) ships it; marking it sent here is safe
        because there is exactly one sender per link."""
        with self._cv:
            consumed = self._consumed_from.get(peer, 0)
            if consumed > self._granted_sent.get(peer, 0):
                self._granted_sent[peer] = consumed
                return consumed
            return None

    def _outstanding_locked(self, peer: int) -> int:
        """Unacknowledged data bytes to ``peer``: encoded-and-sent minus
        granted, plus the mailbox's enqueue-time estimate."""
        sender = self._senders.get(peer)
        queued = sender.queued_bytes if sender is not None else 0
        return (
            self._data_sent.get(peer, 0)
            - self._data_granted.get(peer, 0)
            + queued
        )

    def _wait_for_credit(self, peer: int, est: int) -> None:
        """Producer-side throttle: park until ``est`` more bytes fit in
        the peer's credit window.  Finite wait slices; escapes on grant
        arrival, link failure/close, peer death (isolate quiesces the
        route), or an empty window (one oversized frame always passes —
        the window bounds *accumulation*, not frame size).  This is what
        distinguishes SLOW from DEAD: a slow peer parks us (bounded
        memory), a dead one releases us (frames to it are dropped)."""
        t0_ns = None
        with self._cv:
            while True:
                if self._closed or self._failed is not None:
                    break
                if self._peer_state.get(peer) == PEER_DEAD:
                    break
                if peer not in self._senders:
                    break
                outstanding = self._outstanding_locked(peer)
                if outstanding <= 0 or outstanding + est <= self.credit_bytes:
                    break
                if t0_ns is None:
                    t0_ns = _time.monotonic_ns()
                    with self.stats_lock:
                        self.stats["credit_stalls"] += 1
                self._cv.wait(0.05)
        if t0_ns is not None:
            t1_ns = _time.monotonic_ns()
            with self.stats_lock:
                self.stats["credit_stall_ms"] += (t1_ns - t0_ns) / 1e6
            _tracing.record_span(
                "credit_wait", t0_ns, t1_ns,
                args={"src": self.process_id, "dst": peer, "bytes": est},
            )

    def exchange_pressure(self) -> dict[str, Any]:
        """Per-peer credit backlog snapshot for /metrics + /status."""
        with self._cv:
            peers = {}
            for p in range(self.n_processes):
                if p == self.process_id:
                    continue
                peers[p] = {
                    "backlog_bytes": max(0, self._outstanding_locked(p)),
                    "state": self._peer_state.get(p, PEER_ALIVE),
                }
        with self.stats_lock:
            stalls = self.stats["credit_stalls"]
            stall_ms = self.stats["credit_stall_ms"]
        return {
            "credit_bytes": self.credit_bytes,
            "peers": peers,
            "credit_stalls_total": stalls,
            "credit_stall_ms_total": round(stall_ms, 3),
        }

    def pressure_level(self) -> float:
        """Worst per-peer window occupancy in [0, 1] (0 when disabled)."""
        if self.credit_bytes <= 0:
            return 0.0
        with self._cv:
            worst = 0
            for p in range(self.n_processes):
                if p != self.process_id:
                    worst = max(worst, self._outstanding_locked(p))
        return min(1.0, worst / self.credit_bytes)

    # ------------------------------------------------------------------
    def send_async(self, peer: int, slot: Any, obj: Any) -> None:
        """Queue a pickled-object message; the sender thread coalesces it
        with whatever else is outbound to this peer.  A frame addressed
        to a dead peer (isolate policy) is dropped — its route is
        quiesced, and the rejoin handshake re-opens it.  Control objects
        are credit-exempt: statuses, gathers, and barriers must flow even
        with the data window full, or the mesh would deadlock."""
        sender = self._senders.get(peer)
        if sender is not None:
            sender.enqueue(slot, _K_OBJ, obj)

    def send_updates_async(self, peer: int, slot: Any, boxes: list) -> None:
        """Queue an update-box frame (``boxes[src_tid][dst_tid]`` lists of
        Updates); serialization happens on the sender thread.  With credit
        flow control on, first waits for window room — backpressure
        propagates to the calling worker, which stops cutting epochs,
        which fills the ingest buffer, which pauses the readers."""
        est = _est_boxes_bytes(boxes)
        if self.credit_bytes > 0:
            self._wait_for_credit(peer, est)
        sender = self._senders.get(peer)
        if sender is not None:
            sender.enqueue(slot, _K_UPDATES, boxes, est=est)

    def send_frames_async(self, peer: int, slot: Any, boxes: list) -> None:
        """Queue a columnar-box frame (``boxes[src_tid][dst_tid]`` lists
        of Updates OR :class:`ColumnarBatch`); frame segments are packed
        zero-copy on the sender thread.  Same credit discipline as
        ``send_updates_async`` — columnar data is still data."""
        native = _native_mod.load()
        if native is None:
            # no native codec, so no frames exist to preserve anyway
            return self.send_updates_async(peer, slot, boxes)
        est = _est_frame_boxes_bytes(boxes, native)
        if self.credit_bytes > 0:
            self._wait_for_credit(peer, est)
        sender = self._senders.get(peer)
        if sender is not None:
            sender.enqueue(slot, _K_FRAME, boxes, est=est)

    def recv_from_all(self, slot: Any) -> dict[int, Any]:
        """Block until every *live* peer delivered a payload for ``slot``.

        A notified wait: the reader threads ``notify_all`` on every
        deposit, ``_fail`` notifies on link loss, and ``_fail_peer``
        notifies on a single-peer death (so nobody blocks on a dead
        peer).  Under the ``together`` policy the live set is all peers
        and any failure raises; under ``isolate`` dead peers are simply
        absent from the returned dict — degraded, not dead.  The wait
        timeout is defense-in-depth only (failure detection lives in the
        readers' liveness deadlines)."""
        with self._cv:
            while True:
                if self._failed is not None:
                    raise RuntimeError(f"cluster failure: {self._failed}")
                got = self._inbox.get(slot)
                out = None
                if self.fail_policy == "isolate":
                    live = [
                        p
                        for p in range(self.n_processes)
                        if p != self.process_id
                        and self._peer_state.get(p) != PEER_DEAD
                    ]
                    have = got if got is not None else {}
                    if all(p in have for p in live):
                        out = {p: have.pop(p) for p in live}
                        if not have:
                            self._inbox.pop(slot, None)
                elif got is not None and len(got) == self.n_processes - 1:
                    out = self._inbox.pop(slot)
                if out is not None:
                    kick = self._consume_slot_locked(slot, out)
                    break
                self._cv.wait(1.0)
        for p in kick:
            sender = self._senders.get(p)
            if sender is not None:
                sender.kick()
        return out

    def _consume_slot_locked(self, slot: Any, out: dict[int, Any]) -> list:
        """Account a satisfied slot's wire bytes as CONSUMED (this is the
        moment a worker actually took delivery); returns the peers whose
        pending grant grew large enough to ship eagerly rather than ride
        the next round's piggyback."""
        kick = []
        sizes = self._inbox_bytes.get(slot)
        if sizes is None:
            return kick
        eager = self.credit_bytes // 8 if self.credit_bytes > 0 else None
        for p in out:
            nb = sizes.pop(p, 0)
            if not nb:
                continue
            consumed = self._consumed_from.get(p, 0) + nb
            self._consumed_from[p] = consumed
            if (
                eager is not None
                and consumed - self._granted_sent.get(p, 0) >= eager
            ):
                kick.append(p)
        if not sizes:
            self._inbox_bytes.pop(slot, None)
        return kick

    def pop_arrivals(self, slot: Any) -> dict[int, int]:
        """Consume the per-peer deposit timestamps (monotonic ns) the
        reader threads recorded for ``slot`` — the collectives turn these
        into per-peer wait spans after the slot is satisfied."""
        with self._cv:
            return self._arrival_ns.pop(slot, {})

    # ------------------------------------------------------------------
    def peer_states(self) -> dict[int, str]:
        """Membership snapshot: peer pid -> ``alive``/``suspect``/``dead``
        (peers never heard from report ``alive`` — absence of evidence is
        not failure under the liveness deadline)."""
        with self._cv:
            return {
                p: self._peer_state.get(p, PEER_ALIVE)
                for p in range(self.n_processes)
                if p != self.process_id
            }

    def dead_peers(self) -> list[int]:
        with self._cv:
            return sorted(
                p
                for p, s in self._peer_state.items()
                if s == PEER_DEAD
            )

    def membership(self) -> dict[int, dict[str, Any]]:
        """Full membership view: per peer ``state``, last advertised
        ``incarnation``, and the death ``reason`` (if dead)."""
        with self._cv:
            return {
                p: {
                    "state": self._peer_state.get(p, PEER_ALIVE),
                    "incarnation": self._peer_incarnation.get(p, 0),
                    "reason": self._dead_reason.get(p),
                }
                for p in range(self.n_processes)
                if p != self.process_id
            }

    def close(self) -> None:
        """Bounded teardown: ask the senders to drain, give them a short
        grace, then close the sockets (which breaks any sender stuck in
        ``sendall`` and any reader parked in ``recv``) and re-join — no
        unbounded join anywhere, so teardown cannot hang."""
        with self._cv:
            self._closed = True
            states = dict(self._peer_state)
            self._cv.notify_all()  # release producers in _wait_for_credit
        senders = list(self._senders.values())
        for sender in senders:
            # a suspect/dead peer's backlog is undeliverable and its
            # socket may be stalled: DROP it — draining would park the
            # sender in sendall for the whole teardown grace
            sender.stop(
                drop_backlog=states.get(sender.peer, PEER_ALIVE) != PEER_ALIVE
            )
        for sender in senders:
            sender.join(0.5)
        for sock in list(self._socks.values()):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        for sender in senders:
            sender.join(1.5)
        for reader in self._readers:
            reader.join(1.5)


class Cluster:
    """Worker topology + collectives for ``threads × processes`` workers.

    Worker global index = ``process_id * threads + thread_id``.  Exchange
    within a process is shared memory; across processes frames travel on
    per-peer sender threads and coalesce into one transmission per peer
    per drain (usually one per epoch round on the steady-state path).
    """

    def __init__(
        self,
        *,
        threads: int = 1,
        processes: int = 1,
        process_id: int = 0,
        first_port: int = 10000,
        heartbeat_s: float | None = None,
        liveness_timeout_s: float | None = None,
        fail_policy: str | None = None,
        incarnation: int | None = None,
    ):
        self.threads = threads
        self.processes = processes
        self.process_id = process_id
        self.n_workers = threads * processes
        #: shared wakeup channel: connector enqueues, frame arrivals,
        #: collective deposits, the gc pacer and stop() all notify it;
        #: the scheduler's idle branch parks on it instead of sleeping
        self.wakeup = WakeupHub()
        #: per-stage latency probe (set by the scheduler); exchange recv
        #: waits are recorded here when present
        self.latency: Any = None
        self._links = (
            _ProcessLinks(
                process_id,
                processes,
                first_port,
                hub=self.wakeup,
                heartbeat_s=heartbeat_s,
                liveness_timeout_s=liveness_timeout_s,
                fail_policy=fail_policy,
                incarnation=incarnation,
            )
            if processes > 1
            else None
        )
        self._barrier = threading.Barrier(threads)
        self._local: dict[Any, Any] = {}  # slot -> per-tid deposits
        self._merged: dict[Any, Any] = {}  # slot -> per-tid results
        self._lock = threading.Lock()
        #: collective-level counters (thread 0 only mutates, so no lock);
        #: transport counters live on the links — exchange_stats() merges
        self._stats: dict[str, Any] = {
            "exchange_calls": 0,
            "allgather_calls": 0,
            "status_rounds": 0,
            "recv_wait_ms": 0.0,
            "allgather_wait_ms": 0.0,
            "status_wait_ms": 0.0,
            # the aggregate status_wait_ms split by the peer whose frame
            # arrived at that offset into the wait — the trace records the
            # same split as per-round "status_wait_peer" spans
            "status_wait_by_peer_ms": {},
        }
        #: last epoch trace context received via the round-status
        #: piggyback from rank 0 (None until the first piggybacked round;
        #: tests assert genuine cross-rank propagation through this)
        self.last_epoch_wire: Any = None
        if processes > 1:
            _tracing.set_rank(process_id)

    def worker_index(self, thread_id: int) -> int:
        return self.process_id * self.threads + thread_id

    def peer_states(self) -> dict[int, str]:
        """Membership snapshot (``{}`` for a single-process cluster)."""
        return {} if self._links is None else self._links.peer_states()

    def membership(self) -> dict[int, dict[str, Any]]:
        return {} if self._links is None else self._links.membership()

    def exchange_pressure(self) -> dict[str, Any]:
        """Per-peer credit backlog (``{}`` for a single-process cluster)."""
        return {} if self._links is None else self._links.exchange_pressure()

    def pressure_level(self) -> float:
        """Worst peer credit-window occupancy in [0, 1]."""
        return 0.0 if self._links is None else self._links.pressure_level()

    def exchange_stats(self) -> dict[str, Any]:
        """Snapshot of the exchange-overhead probe: collective counts and
        wait times plus transport pack/send/unpack times and volumes."""
        st = dict(self._stats)
        st["status_wait_by_peer_ms"] = dict(st["status_wait_by_peer_ms"])
        if self._links is not None:
            with self._links.stats_lock:
                st.update(self._links.stats)
        return st

    # ------------------------------------------------------------------
    def exchange(
        self, slot: Any, thread_id: int, outboxes: list[list]
    ) -> list:
        """All-to-all: ``outboxes[w]`` holds this worker's updates destined
        to global worker ``w``; returns the merged inbox for this worker,
        concatenated in global source-worker order.

        Outbound frames are queued to the per-peer sender threads (which
        pack them in the native binary codec and coalesce them with any
        other outbound traffic); the wait below is a mailbox wait on the
        peers' DATA — the reader threads have already deserialized it.
        """
        T, P = self.threads, self.processes
        # exchange stage = this worker's whole all-to-all (barrier sync +
        # mailbox recv + merge); recorded once per collective on thread 0
        lat = self.latency if thread_id == 0 else None
        t_x0 = _time.perf_counter() if lat is not None else 0.0
        t_x0_ns = _time.monotonic_ns() if thread_id == 0 else 0
        with self._lock:
            self._local.setdefault(slot, {})[thread_id] = outboxes
        self._barrier.wait()
        if thread_id == 0:
            st = self._stats
            st["exchange_calls"] += 1
            local = self._local.pop(slot)
            if self._links is not None:
                for peer in range(P):
                    if peer == self.process_id:
                        continue
                    boxes = [
                        [
                            local[src_tid][peer * T + dst_tid]
                            for dst_tid in range(T)
                        ]
                        for src_tid in range(T)
                    ]
                    if any(
                        isinstance(b, ColumnarBatch)
                        for row in boxes
                        for b in row
                    ):
                        self._links.send_frames_async(peer, slot, boxes)
                    else:
                        self._links.send_updates_async(peer, slot, boxes)
                t0 = _time.perf_counter()
                t0_ns = _time.monotonic_ns()
                remote = self._links.recv_from_all(slot)
                wait_s = _time.perf_counter() - t0
                st["recv_wait_ms"] += wait_s * 1e3
                # per-peer recv spans: each peer's frame arrival stamps how
                # long THIS rank's exchange waited on THAT rank — the span
                # names both sides (src = sender, dst = this rank)
                arrivals = self._links.pop_arrivals(slot)
                if _tracing.enabled():
                    for peer, arr_ns in arrivals.items():
                        _tracing.record_span(
                            "exchange_recv", t0_ns, max(arr_ns, t0_ns),
                            args={"src": peer, "dst": self.process_id},
                        )
            else:
                remote = {}
            merged: list[list] = [[] for _ in range(T)]
            base = self.process_id * T
            for src_pid in range(P):
                if src_pid == self.process_id:
                    for src_tid in range(T):
                        boxes = local[src_tid]
                        for dst_tid in range(T):
                            merged[dst_tid] = extend_batch(
                                merged[dst_tid], boxes[base + dst_tid]
                            )
                else:
                    rows = remote.get(src_pid)  # decoded by the reader
                    if rows is None:
                        continue  # peer dead (isolate): degraded merge
                    for src_tid in range(T):
                        row = rows[src_tid]
                        for dst_tid in range(T):
                            merged[dst_tid] = extend_batch(
                                merged[dst_tid], row[dst_tid]
                            )
            with self._lock:
                self._merged[slot] = merged
        self._barrier.wait()
        with self._lock:
            merged = self._merged[slot]
            result = merged[thread_id]
            merged[thread_id] = None  # type: ignore[call-overload]
            if all(m is None for m in merged):
                self._merged.pop(slot, None)
        if lat is not None:
            lat.record("exchange", int((_time.perf_counter() - t_x0) * 1e9))
        if thread_id == 0:
            _tracing.record_span(
                "exchange", t_x0_ns, _time.monotonic_ns(),
                args={"rank": self.process_id},
            )
        return result

    # ------------------------------------------------------------------
    def _gather(
        self, slot: Any, thread_id: int, obj: Any, calls_key: str, wait_key: str
    ) -> list:
        """Shared gather: every worker contributes one object; every worker
        receives the list of all objects in global worker order."""
        T, P = self.threads, self.processes
        with self._lock:
            self._local.setdefault(slot, {})[thread_id] = obj
        # a worker entering a collective is itself a wakeup: siblings
        # parked in the scheduler's idle branch must join this round
        self.wakeup.notify()
        self._barrier.wait()
        if thread_id == 0:
            st = self._stats
            st[calls_key] += 1
            local = self._local.pop(slot)
            if self._links is not None:
                payload = [local[tid] for tid in range(T)]
                for peer in range(P):
                    if peer != self.process_id:
                        self._links.send_async(peer, slot, payload)
                t0 = _time.perf_counter()
                t0_ns = _time.monotonic_ns()
                remote = self._links.recv_from_all(slot)
                st[wait_key] += (_time.perf_counter() - t0) * 1e3
                # satellite: split the opaque wait by WHICH peer held it —
                # each peer's deposit timestamp bounds this rank's wait on
                # that peer; status rounds additionally emit per-peer spans
                # so a slow rank is attributable to specific rounds
                arrivals = self._links.pop_arrivals(slot)
                if wait_key == "status_wait_ms":
                    by_peer = st["status_wait_by_peer_ms"]
                    round_no = slot[1] if isinstance(slot, tuple) else None
                    ctx = (
                        epoch_trace_context(round_no)
                        if round_no is not None and _tracing.enabled()
                        else None
                    )
                    for peer, arr_ns in arrivals.items():
                        waited_ns = max(arr_ns - t0_ns, 0)
                        by_peer[peer] = (
                            by_peer.get(peer, 0.0) + waited_ns / 1e6
                        )
                        if ctx is not None:
                            _tracing.record_span(
                                "status_wait_peer", t0_ns,
                                t0_ns + waited_ns, ctx=ctx,
                                args={
                                    "src": peer,
                                    "dst": self.process_id,
                                    "round": round_no,
                                },
                            )
            else:
                remote = {}
            gathered: list = []
            for src_pid in range(P):
                if src_pid == self.process_id:
                    gathered.extend(local[tid] for tid in range(T))
                else:
                    part = remote.get(src_pid)
                    if part is not None:  # dead peer (isolate): absent
                        gathered.extend(part)
            with self._lock:
                self._merged[slot] = gathered
        self._barrier.wait()
        with self._lock:
            gathered = self._merged[slot]
            # every thread reads the same list; last reader cleans up
            counter = self._local.setdefault(("__done__", slot), {"n": 0})
            counter["n"] += 1
            if counter["n"] == T:
                self._merged.pop(slot, None)
                self._local.pop(("__done__", slot), None)
        return gathered

    def allgather(self, slot: Any, thread_id: int, obj: Any) -> list:
        """Run-boundary gather (replay length, snapshot presence, final
        error log): O(1) calls per run.  The per-round epoch-cut gather is
        :meth:`round_statuses` — keeping them distinct keeps the steady
        state at exactly one synchronization rendezvous per round."""
        return self._gather(
            slot, thread_id, obj, "allgather_calls", "allgather_wait_ms"
        )

    def round_statuses(self, round_no: int, thread_id: int, status: Any) -> list:
        """Epoch-cut consensus for one scheduler round: gathers every
        worker's status tuple.  The status message rides the same framed
        stream as data — the sender thread coalesces it with any operator
        frames still outbound (piggybacked consensus), and an idle round
        sends it as a lone tiny transmission (the empty-frame fallback).

        Trace piggyback: rank 0's thread 0 rides its epoch trace context
        on its status contribution — every rank derives the same context
        deterministically (:func:`epoch_trace_context`), so this is the
        *confirmation* channel that stitches cross-rank spans: receivers
        remember the last wire context (``last_epoch_wire``), and the
        wrapper is stripped before the statuses reach the scheduler (its
        ``s[0..8]`` indexing never sees it)."""
        tracing_on = _tracing.enabled()
        if tracing_on and thread_id == 0 and self.process_id == 0:
            status = (
                "#tc", epoch_trace_context(round_no).to_wire(), status
            )
        gathered = self._gather(
            ("s", round_no), thread_id, status, "status_rounds", "status_wait_ms"
        )
        # unwrap unconditionally: rank 0 may have tracing on while this
        # rank has it off, and the scheduler must never see the wrapper
        out = []
        for s in gathered:
            if isinstance(s, tuple) and len(s) == 3 and s[0] == "#tc":
                self.last_epoch_wire = s[1]
                out.append(s[2])
            else:
                out.append(s)
        return out

    def close(self) -> None:
        self._barrier.abort()  # free local threads blocked in a collective
        self.wakeup.notify()  # free threads parked in the idle branch
        if self._links is not None:
            self._links.close()


def epoch_trace_context(round_no: int) -> "_tracing.TraceContext":
    """The deterministic trace context for one cluster round: every rank
    derives the identical trace id from the round number alone (FNV-1a —
    NOT the builtin ``hash``, which is salted per process), so spans
    recorded on different ranks stitch under one trace without waiting
    for the piggybacked context to arrive.  The rank-0 context riding the
    round-status frames (:meth:`Cluster.round_statuses`) then confirms
    the stitch — and is what tests assert genuine propagation on."""
    h = 0xCBF29CE484222325
    for b in b"epoch:%d" % round_no:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    h = h or 1
    return _tracing.TraceContext(h, h, True)


def route_by_key(u: Any) -> int:
    """Default co-location: the row key (already a 128-bit stable hash)."""
    return int(u.key)


#: native route_split spec: empty tuple = key-value routing (see
#: native/pathway_native.cpp py_route_split)
route_by_key.positional = ()  # type: ignore[attr-defined]


def route_to_zero(_u: Any) -> int:
    """Centralized operators (temporal buffers, external indexes, outputs):
    the reference shards these to a single worker too
    (``TimeKey::shard() -> 1``, ``src/engine/dataflow/operators/time_column.rs:44-52``)."""
    return 0


#: scheduler fast path: everything to worker 0 without a per-row call
route_to_zero.const_zero = True  # type: ignore[attr-defined]


def route_all_to_zero(node: Any) -> list:
    """``exchange_routes`` implementation for centralized operators: one
    ``route_to_zero`` per input port.  Assign directly as a method:
    ``MyNode.exchange_routes = cluster.route_all_to_zero``."""
    return [route_to_zero] * max(1, len(node.inputs))


def route_by(fn: Callable[[Any, tuple], Any]) -> Callable[[Any], int]:
    """Route by a computed co-location value (group values, join key,
    instance)."""

    def route(u: Any) -> int:
        vals = fn(u.key, u.values)
        if isinstance(vals, tuple):
            return stable_shard(*vals)
        return stable_shard(vals)

    return route
