"""Retraction-aware reducer implementations.

Capability parity with reference ``src/engine/reduce.rs`` (count, sums,
min/max, argmin/argmax, unique, any, sorted_tuple, tuple, earliest/latest,
stateful Python reducers).  Each reducer maintains an accumulator that
supports ``add``/``remove`` with multiplicities; non-invertible reducers
(min/max/unique/...) keep a multiset counter and recompute on extract — the
group sizes seen in streaming ETL make O(distinct) extraction acceptable, and
only dirty groups are re-extracted per epoch.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.engine.stream import hashable


class ReducerImpl:
    """One reducer instance bound to its argument extractors."""

    name = "reducer"
    # how many expression arguments the reducer consumes
    n_args = 1
    #: native partial-aggregation code (native/pathway_native.cpp
    #: groupby_partials): 0 = count, 1 = sum-like, 2 = multiset,
    #: None = no native fast path for this reducer
    native_code: int | None = None

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.ANY

    def make_acc(self) -> Any:
        raise NotImplementedError

    def update(self, acc: Any, args: tuple, diff: int) -> None:
        raise NotImplementedError

    def merge_partial(self, acc: Any, partial: Any) -> None:
        """Fold one native partial (see ``native_code``) into ``acc``."""
        raise NotImplementedError

    def extract(self, acc: Any) -> Any:
        raise NotImplementedError


class CountReducer(ReducerImpl):
    name = "count"
    n_args = 0
    native_code = 0

    def return_dtype(self, arg_dtypes):
        return dt.INT

    def make_acc(self):
        return [0]

    def update(self, acc, args, diff):
        acc[0] += diff

    def merge_partial(self, acc, partial):
        acc[0] += partial

    def extract(self, acc):
        return acc[0]


class SumReducer(ReducerImpl):
    name = "sum"
    native_code = 1

    def return_dtype(self, arg_dtypes):
        return arg_dtypes[0] if arg_dtypes else dt.ANY

    def make_acc(self):
        return [None, 0]  # total, count

    def update(self, acc, args, diff):
        v = args[0]
        if v is None or v is api.ERROR:
            return
        if acc[0] is None:
            acc[0] = v * diff if not isinstance(v, np.ndarray) else v * diff
        else:
            acc[0] = acc[0] + v * diff
        acc[1] += diff

    def merge_partial(self, acc, partial):
        total, cnt = partial
        if total is None:
            return
        acc[0] = total if acc[0] is None else acc[0] + total
        acc[1] += cnt

    def extract(self, acc):
        if acc[1] == 0 and not isinstance(acc[0], np.ndarray):
            return 0 if acc[0] is None else type(acc[0])(0) if isinstance(acc[0], (int, float)) else acc[0]
        return acc[0]


class AvgReducer(ReducerImpl):
    name = "avg"
    native_code = 1

    def return_dtype(self, arg_dtypes):
        return dt.FLOAT

    def make_acc(self):
        return [0.0, 0]

    def update(self, acc, args, diff):
        v = args[0]
        if v is None or v is api.ERROR:
            return
        acc[0] += v * diff
        acc[1] += diff

    def merge_partial(self, acc, partial):
        total, cnt = partial
        if total is None:
            return
        acc[0] += total
        acc[1] += cnt

    def extract(self, acc):
        return acc[0] / acc[1] if acc[1] else None


class _MultisetReducer(ReducerImpl):
    """Base for non-invertible reducers: keeps Counter of hashable args with
    original values remembered for extraction."""

    def make_acc(self):
        return {"counter": Counter(), "orig": {}}

    native_code = 2

    def update(self, acc, args, diff):
        # Signed accumulation: counts may go transiently negative (a
        # retraction arriving before its matching addition inside one
        # batch) and are clamped only at extract time via _items.  This
        # matches the native groupby_partials netting semantics — the
        # native path nets per-batch deltas before applying them, so
        # clamping per-event here would diverge on inconsistent streams.
        h = hashable(args)
        c = acc["counter"][h] + diff
        if c == 0:
            del acc["counter"][h]
            acc["orig"].pop(h, None)
        else:
            acc["counter"][h] = c
            acc["orig"].setdefault(h, args)

    def merge_partial(self, acc, partial):
        counter = acc["counter"]
        orig = acc["orig"]
        for h, (delta, args) in partial.items():
            c = counter[h] + delta
            if c == 0:
                del counter[h]
                orig.pop(h, None)
            else:
                counter[h] = c
                orig.setdefault(h, args)

    def _items(self, acc):
        # only positive multiplicities are visible; negatives are pending
        # retractions awaiting their additions
        return [(acc["orig"][h], c) for h, c in acc["counter"].items() if c > 0]


class MinReducer(_MultisetReducer):
    name = "min"

    def return_dtype(self, arg_dtypes):
        return arg_dtypes[0]

    def extract(self, acc):
        vals = [v[0] for v, _ in self._items(acc) if v[0] is not None]
        return min(vals) if vals else None


class MaxReducer(MinReducer):
    name = "max"

    def extract(self, acc):
        vals = [v[0] for v, _ in self._items(acc) if v[0] is not None]
        return max(vals) if vals else None


class ArgMinReducer(_MultisetReducer):
    """args = (value, key_pointer)."""

    name = "argmin"
    n_args = 2

    def return_dtype(self, arg_dtypes):
        return dt.POINTER

    def _pick(self, acc, fn):
        items = [v for v, _ in self._items(acc) if v[0] is not None]
        if not items:
            return None
        best = fn(items, key=lambda p: (p[0], p[1]))
        return best[1]

    def extract(self, acc):
        return self._pick(acc, min)


class ArgMaxReducer(ArgMinReducer):
    name = "argmax"

    def extract(self, acc):
        return self._pick(acc, max)


class UniqueReducer(_MultisetReducer):
    name = "unique"

    def return_dtype(self, arg_dtypes):
        return arg_dtypes[0]

    def extract(self, acc):
        items = self._items(acc)
        distinct = {hashable(v[0]) for v, _ in items}
        if len(distinct) > 1:
            return api.ERROR
        return items[0][0][0] if items else None


class AnyReducer(_MultisetReducer):
    name = "any"

    def return_dtype(self, arg_dtypes):
        return arg_dtypes[0]

    def extract(self, acc):
        items = self._items(acc)
        if not items:
            return None
        return min(items, key=lambda it: repr(hashable(it[0])))[0][0]


class SortedTupleReducer(_MultisetReducer):
    name = "sorted_tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def return_dtype(self, arg_dtypes):
        return dt.List(arg_dtypes[0] if arg_dtypes else dt.ANY)

    def extract(self, acc):
        out = []
        for v, c in self._items(acc):
            if self.skip_nones and v[0] is None:
                continue
            out.extend([v[0]] * c)
        return tuple(sorted(out, key=lambda x: (x is None, x)))


class TupleReducer(ReducerImpl):
    """Collects values; ordered by insertion sequence (stable across
    retraction of any copy)."""

    name = "tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def return_dtype(self, arg_dtypes):
        return dt.List(arg_dtypes[0] if arg_dtypes else dt.ANY)

    def make_acc(self):
        return {"seq": 0, "items": {}}  # seq_id -> value ; plus index by hash

    def update(self, acc, args, diff):
        v = args[0]
        if diff > 0:
            for _ in range(diff):
                acc["items"][acc["seq"]] = v
                acc["seq"] += 1
        else:
            h = hashable(v)
            to_remove = -diff
            for sid in sorted(acc["items"], reverse=True):
                if to_remove == 0:
                    break
                if hashable(acc["items"][sid]) == h:
                    del acc["items"][sid]
                    to_remove -= 1

    def extract(self, acc):
        vals = [acc["items"][sid] for sid in sorted(acc["items"])]
        if self.skip_nones:
            vals = [v for v in vals if v is not None]
        return tuple(vals)


class EarliestReducer(ReducerImpl):
    name = "earliest"

    def return_dtype(self, arg_dtypes):
        return arg_dtypes[0]

    def make_acc(self):
        return TupleReducer().make_acc()

    def update(self, acc, args, diff):
        TupleReducer().update(acc, args, diff)

    def extract(self, acc):
        if not acc["items"]:
            return None
        return acc["items"][min(acc["items"])]


class LatestReducer(EarliestReducer):
    name = "latest"

    def extract(self, acc):
        if not acc["items"]:
            return None
        return acc["items"][max(acc["items"])]


class NdarrayReducer(ReducerImpl):
    name = "ndarray"

    def return_dtype(self, arg_dtypes):
        return dt.ANY_ARRAY

    def make_acc(self):
        return TupleReducer().make_acc()

    def update(self, acc, args, diff):
        TupleReducer().update(acc, args, diff)

    def extract(self, acc):
        vals = [acc["items"][sid] for sid in sorted(acc["items"])]
        return np.array(vals)


class NpSumReducer(ReducerImpl):
    name = "npsum"

    def return_dtype(self, arg_dtypes):
        return dt.ANY_ARRAY

    def make_acc(self):
        return [None, 0]

    def update(self, acc, args, diff):
        v = args[0]
        if v is None or v is api.ERROR:
            # defense in depth: GroupByNode poisons error args before
            # update(), but a direct caller must not crash on the sentinel
            return
        v = np.asarray(v)
        acc[0] = v * diff if acc[0] is None else acc[0] + v * diff
        acc[1] += diff

    def extract(self, acc):
        return acc[0]


class StatefulReducer(ReducerImpl):
    """Python custom reducer (reference ``stateful_many``/
    ``BaseCustomAccumulator``, ``internals/custom_reducers.py``).  Keeps the
    multiset of rows; folds the user accumulator on extraction, using
    ``retract`` only when available — otherwise replays from scratch."""

    name = "stateful"
    native_code = 2

    def __init__(self, fold: Callable[[list[tuple]], Any], n_args: int = 1):
        self.fold = fold
        self.n_args = n_args
        self._ms = _MultisetReducer()

    def return_dtype(self, arg_dtypes):
        return dt.ANY

    def make_acc(self):
        return self._ms.make_acc()

    def update(self, acc, args, diff):
        self._ms.update(acc, args, diff)

    def merge_partial(self, acc, partial):
        self._ms.merge_partial(acc, partial)

    def extract(self, acc):
        rows: list[tuple] = []
        for v, c in self._ms._items(acc):
            rows.extend([v] * c)
        return self.fold(rows)


class _AppendOnlyExtreme(ReducerImpl):
    """O(1) running-extreme accumulator for inputs the analyzer proved
    append-only (``graph_facts.append_only``): no retraction can ever
    arrive, so the multiset bookkeeping of :class:`_MultisetReducer`
    is dead weight.  Negative diffs are ignored — the optimizer only
    installs these when the proof holds, and the proof is the contract.

    ``native_code`` stays 2: the native partial format (``{h: (delta,
    args)}``) is folded directly, so a swapped reducer keeps the
    groupby's ``fast_spec`` valid.
    """

    native_code = 2

    def _better(self, a: Any, b: Any) -> bool:
        raise NotImplementedError

    def return_dtype(self, arg_dtypes):
        return arg_dtypes[0] if arg_dtypes else dt.ANY

    def make_acc(self):
        return [None]

    def update(self, acc, args, diff):
        if diff <= 0:
            return
        v = args[0]
        if v is None or v is api.ERROR:
            return
        if acc[0] is None or self._better(v, acc[0]):
            acc[0] = v

    def merge_partial(self, acc, partial):
        for _, (delta, args) in partial.items():
            if delta <= 0:
                continue
            v = args[0]
            if v is None or v is api.ERROR:
                continue
            if acc[0] is None or self._better(v, acc[0]):
                acc[0] = v

    def extract(self, acc):
        return acc[0]


class AppendOnlyMinReducer(_AppendOnlyExtreme):
    name = "min"

    def _better(self, a, b):
        return a < b


class AppendOnlyMaxReducer(_AppendOnlyExtreme):
    name = "max"

    def _better(self, a, b):
        return a > b


class _AppendOnlyArgExtreme(_AppendOnlyExtreme):
    """Append-only argmin/argmax: acc holds the best ``(value, key)``
    pair; comparison is lexicographic, matching ``ArgMinReducer._pick``'s
    ``key=lambda p: (p[0], p[1])`` tie-breaking exactly."""

    n_args = 2

    def return_dtype(self, arg_dtypes):
        return dt.POINTER

    def update(self, acc, args, diff):
        if diff <= 0 or args[0] is None or args[0] is api.ERROR:
            return
        pair = (args[0], args[1])
        if acc[0] is None or self._better(pair, acc[0]):
            acc[0] = pair

    def merge_partial(self, acc, partial):
        for _, (delta, args) in partial.items():
            if delta <= 0 or args[0] is None or args[0] is api.ERROR:
                continue
            pair = (args[0], args[1])
            if acc[0] is None or self._better(pair, acc[0]):
                acc[0] = pair

    def extract(self, acc):
        return None if acc[0] is None else acc[0][1]


class AppendOnlyArgMinReducer(_AppendOnlyArgExtreme):
    name = "argmin"

    def _better(self, a, b):
        return a < b


class AppendOnlyArgMaxReducer(_AppendOnlyArgExtreme):
    name = "argmax"

    def _better(self, a, b):
        return a > b


#: exact-type table: MaxReducer subclasses MinReducer, so lookup must be
#: by ``type(impl)``, never isinstance.  Deliberately absent: Unique
#: (needs the distinct count), Any (its pick is defined over the *current*
#: multiset ordering), the tuple family (extraction needs all elements).
_APPEND_ONLY_VARIANTS: dict[type, Callable[[], ReducerImpl]] = {
    MinReducer: AppendOnlyMinReducer,
    MaxReducer: AppendOnlyMaxReducer,
    ArgMinReducer: AppendOnlyArgMinReducer,
    ArgMaxReducer: AppendOnlyArgMaxReducer,
}


def append_only_variant(impl: ReducerImpl) -> "ReducerImpl | None":
    """Non-retracting drop-in for ``impl``, or None when the reducer has
    no append-only specialization (or is already one)."""
    cls = _APPEND_ONLY_VARIANTS.get(type(impl))
    return cls() if cls is not None else None


def make_reducer(name: str, **kwargs: Any) -> ReducerImpl:
    table: dict[str, Callable[[], ReducerImpl]] = {
        "count": CountReducer,
        "sum": SumReducer,
        "avg": AvgReducer,
        "min": MinReducer,
        "max": MaxReducer,
        "argmin": ArgMinReducer,
        "argmax": ArgMaxReducer,
        "unique": UniqueReducer,
        "any": AnyReducer,
        "earliest": EarliestReducer,
        "latest": LatestReducer,
        "ndarray": NdarrayReducer,
        "npsum": NpSumReducer,
    }
    if name == "sorted_tuple":
        return SortedTupleReducer(skip_nones=kwargs.get("skip_nones", False))
    if name == "tuple":
        return TupleReducer(skip_nones=kwargs.get("skip_nones", False))
    return table[name]()
