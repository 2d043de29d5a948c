"""``pw.reducers`` — the user-facing reducer registry.

Capability parity with reference ``python/pathway/reducers.py:28-46`` +
``internals/custom_reducers.py``: any, argmax, argmin, avg, count, earliest,
int_sum, latest, max, min, ndarray, npsum, sorted_tuple, sum, tuple, unique,
plus ``udf_reducer`` / ``stateful_single`` / ``stateful_many`` custom
reducers.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import reducers as engine_reducers
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, ReducerExpression, _wrap


class Reducer:
    def __init__(self, name: str, n_args: int = 1):
        self.name = name
        self.n_args = n_args

    def __call__(self, *args: Any, **kwargs: Any) -> ReducerExpression:
        return ReducerExpression(self, *[_wrap(a) for a in args], **kwargs)

    def make_impl(self, **kwargs: Any) -> engine_reducers.ReducerImpl:
        return engine_reducers.make_reducer(self.name, **kwargs)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return self.make_impl().return_dtype(arg_dtypes)

    def __repr__(self) -> str:
        return f"pw.reducers.{self.name}"


count = Reducer("count", n_args=0)
sum = Reducer("sum")
int_sum = Reducer("sum")
npsum = Reducer("npsum")
ndarray = Reducer("ndarray")
avg = Reducer("avg")
min = Reducer("min")
max = Reducer("max")
argmin = Reducer("argmin")
argmax = Reducer("argmax")
unique = Reducer("unique")
any = Reducer("any")
earliest = Reducer("earliest")
latest = Reducer("latest")
sorted_tuple = Reducer("sorted_tuple")
tuple = Reducer("tuple")


class _StatefulReducer(Reducer):
    def __init__(self, fold: Callable[[list], Any], name: str = "stateful"):
        super().__init__(name)
        self._fold = fold

    def make_impl(self, **kwargs: Any) -> engine_reducers.ReducerImpl:
        return engine_reducers.StatefulReducer(self._fold)

    def return_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.ANY


def stateful_many(combine_many: Callable) -> Reducer:
    """Custom reducer from a combine function over the full multiset of rows
    (reference ``pw.reducers.stateful_many``).  ``combine_many(state, rows)``
    is replayed from ``state=None`` on each extraction — correct under
    retraction without requiring invertibility."""

    def fold(rows: list[Any]) -> Any:
        return combine_many(None, [(r, 1) for r in rows])

    return _StatefulReducer(fold, name="stateful_many")


def stateful_single(combine_single: Callable) -> Reducer:
    def fold(rows: list[Any]) -> Any:
        state = None
        for r in rows:
            state = combine_single(state, *r)
        return state

    return _StatefulReducer(fold, name="stateful_single")


class BaseCustomAccumulator:
    """Reference ``internals/custom_reducers.py`` ``BaseCustomAccumulator``:
    subclass with ``from_row``, ``update``, optional ``retract``, and
    ``compute_result``."""

    @classmethod
    def from_row(cls, row: list[Any]) -> "BaseCustomAccumulator":
        raise NotImplementedError

    def update(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError

    def compute_result(self) -> Any:
        raise NotImplementedError


def udf_reducer(accumulator: type[BaseCustomAccumulator]) -> Reducer:
    def fold(rows: list[Any]) -> Any:
        acc = None
        for r in rows:
            nxt = accumulator.from_row(list(r))
            if acc is None:
                acc = nxt
            else:
                acc.update(nxt)
        return acc.compute_result() if acc is not None else None

    return _StatefulReducer(fold, name=f"udf_reducer_{accumulator.__name__}")
