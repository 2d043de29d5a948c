"""External index dataflow operator (counterpart of
``pathway_tpu/engine/external_index.py``).

Equivalent of the reference's ``use_external_index_as_of_now``
(``src/engine/graph.rs:915``, operator
``src/engine/dataflow/operators/external_index.rs``, framework
``src/external_integration/mod.rs:40-181``): an index side (documents)
feeds adds/retractions into an index object; a query side gets each
query answered against the index.

Two consistency modes:

- ``as_of_now=True`` (reference semantics): a query is answered ONCE
  against the index state at its arrival epoch; later index updates do
  not revise past answers.  Query retractions retract the cached answer.
- ``as_of_now=False`` (fully consistent ``DataIndex.query``): live
  queries are re-answered whenever the index changes, emitting
  retraction/addition diffs.

All queries of an epoch are answered in ONE batched ``search`` call —
on the card-resident index that is one fused score + top-k launch (K3,
``kernels/knn_topk.py``) or one IVF scan (K12).
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, Sequence

from pathway_tpu_torch.engine.graph import EngineGraph, Node
from pathway_tpu_torch.engine.stream import Batch, Update, consolidate, per_key_changes
from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals.keys import Pointer


class IndexAdapter(Protocol):
    """Host-side index contract (reference ``trait ExternalIndex``,
    ``src/external_integration/mod.rs:40-48``)."""

    def add(self, items: Sequence[tuple[Any, Any]]) -> None: ...

    def remove(self, keys: Sequence[Any]) -> None: ...

    def search(
        self,
        payloads: Sequence[Any],
        k: Sequence[int],
        filters: Sequence[Callable[[dict], bool] | None],
    ) -> list[list[tuple[Any, float]]]: ...


class ExternalIndexNode(Node):
    """inputs = [index_side, query_side].

    Output row = query_values + (ids, scores, datas) where each of the
    three is a tuple aligned by rank; ``datas`` carries the indexed
    row's data snapshot taken at answer time.
    """

    def __init__(
        self,
        graph: EngineGraph,
        index_input: Node,
        query_input: Node,
        adapter: IndexAdapter,
        *,
        index_payload_fn: Callable[[Pointer, tuple], Any],
        index_data_fn: Callable[[Pointer, tuple], Any] | None = None,
        index_meta_fn: Callable[[Pointer, tuple], dict | None] | None = None,
        query_payload_fn: Callable[[Pointer, tuple], Any],
        query_k_fn: Callable[[Pointer, tuple], int],
        query_filter_fn: Callable[[Pointer, tuple], Any] | None = None,
        as_of_now: bool = True,
        name: str = "external_index",
    ):
        super().__init__(graph, [index_input, query_input], name)
        self.adapter = adapter
        self.index_payload_fn = index_payload_fn
        self.index_data_fn = index_data_fn or (lambda k, v: None)
        self.index_meta_fn = index_meta_fn or (lambda k, v: None)
        self.query_payload_fn = query_payload_fn
        self.query_k_fn = query_k_fn
        self.query_filter_fn = query_filter_fn or (lambda k, v: None)
        self.as_of_now = as_of_now

    def make_state(self):
        return {
            "docs": {},  # key -> (data, meta)
            "queries": {},  # live queries (non-as-of-now): key -> values
            "out": {},  # query key -> emitted result tuple
        }

    # ------------------------------------------------------------------
    def _apply_index_batch(self, st: dict, batch: Batch) -> bool:
        """Apply doc adds/removals to the adapter; True if anything changed."""
        if not batch:
            return False
        changes = per_key_changes(batch)
        removals: list[Any] = []
        additions: list[tuple[Any, Any]] = []
        for key, (rem, add) in changes.items():
            if add:
                values = add[-1]
                try:
                    payload = self.index_payload_fn(key, values)
                except Exception as e:  # noqa: BLE001
                    payload = None
                    self._log_error(f"index payload failed: {e!r}")
                if payload is None or payload is api.ERROR:
                    # unindexable row: drop (and forget any previous version)
                    if key in st["docs"]:
                        removals.append(key)
                        del st["docs"][key]
                    continue
                additions.append((key, payload))
                st["docs"][key] = (
                    self.index_data_fn(key, values),
                    self.index_meta_fn(key, values),
                )
            elif rem and key in st["docs"]:
                removals.append(key)
                del st["docs"][key]
        changed = False
        if removals:
            try:
                self.adapter.remove(removals)
                changed = True
            except Exception as e:  # noqa: BLE001
                self._log_error(f"index remove failed: {e!r}")
        if additions:
            try:
                self.adapter.add(additions)  # upsert semantics
                changed = True
                if hasattr(self.adapter, "set_meta"):
                    for key, _payload in additions:
                        self.adapter.set_meta(key, st["docs"][key][1])
            except Exception as e:  # noqa: BLE001
                # one bad batch must not abort the streaming run
                self._log_error(f"index add failed: {e!r}")
                for key, _payload in additions:
                    st["docs"].pop(key, None)
        return changed

    def _log_error(self, msg: str) -> None:
        self._ctx.log_error(self, f"{self.name}: {msg}")

    def _filter_for(self, key: Pointer, values: tuple):
        spec = self.query_filter_fn(key, values)
        if spec is None or spec is api.ERROR:
            return None
        if callable(spec):
            return spec
        from pathway_tpu_torch.stdlib.indexing.filters import compile_filter

        return compile_filter(str(spec))

    def _answer(
        self, st: dict, items: list[tuple[Pointer, tuple]]
    ) -> list[tuple]:
        """Batched search; returns result column tuples aligned with items."""
        payloads, ks, filters = [], [], []
        for key, values in items:
            try:
                payloads.append(self.query_payload_fn(key, values))
            except Exception as e:  # noqa: BLE001
                self._log_error(f"query payload failed: {e!r}")
                payloads.append(None)
            try:
                k = int(self.query_k_fn(key, values))
            except Exception:
                k = 3
            ks.append(max(k, 0))
            try:
                filters.append(self._filter_for(key, values))
            except Exception as e:  # noqa: BLE001
                self._log_error(f"bad metadata filter: {e!r}")
                filters.append(None)
        # queries with unusable payloads get empty replies; the rest go to
        # the adapter in one batch
        clean = [i for i, p in enumerate(payloads) if p is not None and p is not api.ERROR]
        replies = [[] for _ in items]
        if clean:
            try:
                sub = self.adapter.search(
                    [payloads[i] for i in clean],
                    [ks[i] for i in clean],
                    [filters[i] for i in clean],
                )
                for i, r in zip(clean, sub):
                    replies[i] = r
            except Exception as e:  # noqa: BLE001
                self._log_error(f"search failed: {e!r}")
        out = []
        for reply in replies:
            ids = tuple(k for k, _ in reply)
            scores = tuple(float(s) for _, s in reply)
            datas = tuple(
                st["docs"].get(k, (None, None))[0] for k, _ in reply
            )
            out.append((ids, scores, datas))
        return out

    # ------------------------------------------------------------------
    # persistence: the adapter's index is large out-of-band state — fold
    # a serialized copy into the operator snapshot so a restarted worker
    # restores it at the checkpointed epoch and replays only the tail
    # instead of re-embedding/re-inserting the whole corpus

    def snapshot_state(self, ctx):
        if getattr(ctx, "worker_id", 0) != 0:
            return None  # route_all_to_zero: worker 0 owns the index
        sd = getattr(self.adapter, "state_dict", None)
        if sd is None:
            return None
        st = ctx.state(self)
        return {**st, "__index__": sd()}

    def on_restore(self, ctx):
        st = ctx.states.get(self.id)
        if not isinstance(st, dict):
            return
        index_state = st.pop("__index__", None)
        if index_state is None:
            return
        load = getattr(self.adapter, "load_state_dict", None)
        if load is not None:
            load(index_state)

    # ------------------------------------------------------------------
    def process(self, ctx, time, inbatches):
        st = ctx.state(self)
        self._ctx = ctx
        index_changed = self._apply_index_batch(st, inbatches[0])
        out: list[Update] = []

        qbatch = consolidate(inbatches[1])
        added: list[tuple[Pointer, tuple]] = []
        for u in qbatch:
            if u.diff > 0:
                added.append((u.key, u.values))
                if not self.as_of_now:
                    st["queries"][u.key] = u.values
            else:
                if not self.as_of_now:
                    st["queries"].pop(u.key, None)
                prev = st["out"].pop(u.key, None)
                if prev is not None:
                    out.append(Update(u.key, prev, -1))

        recompute: list[tuple[Pointer, tuple]] = list(added)
        if not self.as_of_now and index_changed:
            added_keys = {k for k, _ in added}
            recompute += [
                (k, v) for k, v in st["queries"].items() if k not in added_keys
            ]

        if recompute:
            results = self._answer(st, recompute)
            for (key, values), res in zip(recompute, results):
                row = values + res
                prev = st["out"].get(key)
                if prev == row:
                    continue
                if prev is not None:
                    out.append(Update(key, prev, -1))
                out.append(Update(key, row, 1))
                st["out"][key] = row
        if self.as_of_now:
            # answered queries need no further state unless retracted later;
            # keep out-cache only (it backs retraction replay)
            pass
        return consolidate(out)


# index + queries live on worker 0: the device-plane slab has one host
# owner (the reference replicates indexes per worker instead, which a
# single shared slab on the card replaces)
from pathway_tpu_torch.engine import cluster as _cl

ExternalIndexNode.exchange_routes = _cl.route_all_to_zero
