"""Hidden Markov model smoothing (reference ``stdlib/ml/hmm.py``, 210 LoC:
``create_hmm_reducer`` — Viterbi decoding over recent observations,
packaged as a stateful reducer)."""

from __future__ import annotations

from typing import Any, Callable, Hashable

import numpy as np

from pathway_tpu_torch.reducers import _StatefulReducer

__all__ = ["create_hmm_reducer"]


def create_hmm_reducer(
    graph: dict[Hashable, dict[Hashable, float]] | None = None,
    *,
    states: list | None = None,
    transition: Any = None,
    emission: Callable[[Any, Any], float] | None = None,
    num_results_kept: int | None = 100,
) -> Any:
    """Stateful reducer decoding the most likely CURRENT hidden state from
    the group's observations (Viterbi forward pass).

    Apply to ``(time, observation)`` tuples so decoding respects event
    order::

        smoothed = t.groupby(t.k).reduce(
            state=hmm_reducer(pw.make_tuple(t.t, t.obs)))

    Either pass ``graph`` = {state: {state: prob}} plus optional
    ``emission(state, obs) -> prob``, or ``states`` + ``transition``.
    """
    if graph is not None:
        states = list(graph.keys())
        trans = np.array(
            [[graph[a].get(b, 1e-12) for b in states] for a in states], np.float64
        )
    else:
        assert states is not None and transition is not None
        trans = np.asarray(transition, np.float64)
    log_trans = np.log(np.maximum(trans, 1e-300))
    n = len(states)
    emit_fn = emission or (lambda state, obs: 1.0 if state == obs else 1e-6)
    keep = num_results_kept or 100

    def fold(rows: list[Any]) -> Any:
        # rows: multiset of (time, obs) argument tuples; sort by time
        seq = sorted((r[0] if len(r) == 1 else r for r in rows), key=lambda p: p[0])
        seq = seq[-keep:]
        scores = np.zeros(n, np.float64)
        for _t, obs in seq:
            emit = np.log(
                np.maximum([emit_fn(s, obs) for s in states], 1e-300)
            )
            scores = np.max(scores[:, None] + log_trans, axis=0) + emit
            scores -= scores.max()
        return states[int(np.argmax(scores))] if len(seq) else None

    return _StatefulReducer(fold, name="hmm")
