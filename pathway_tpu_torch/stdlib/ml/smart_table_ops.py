"""Fuzzy join (reference ``stdlib/ml/smart_table_ops/_fuzzy_join.py``):
match rows of two tables by weighted feature similarity — tokenize or
letter features, inverse-frequency normalization (discrete weight /
logweight), greedy highest-weight matching, with optional by-hand
overrides (``smart_fuzzy_match``)."""

from __future__ import annotations

import math
import re
from enum import IntEnum, auto
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table

__all__ = [
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "fuzzy_match_tables",
    "fuzzy_self_match",
    "smart_fuzzy_match",
]

_TOKEN = re.compile(r"[a-z0-9]+")


def _tokenize(s: Any) -> set[str]:
    return set(_TOKEN.findall(str(s).lower()))


def _letters(s: Any) -> set[str]:
    return {ch for ch in str(s).lower() if ch.isalnum()}


class FuzzyJoinFeatureGeneration(IntEnum):
    """reference ``FuzzyJoinFeatureGeneration`` (AUTO == TOKENIZE)."""

    AUTO = auto()
    TOKENIZE = auto()
    LETTERS = auto()

    @property
    def generate(self) -> Callable[[Any], set]:
        if self == FuzzyJoinFeatureGeneration.LETTERS:
            return _letters
        return _tokenize


def _discrete_weight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1 / (2 ** math.ceil(math.log2(cnt)))


def _discrete_logweight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1 / math.ceil(math.log2(cnt + 1))


class FuzzyJoinNormalization(IntEnum):
    """reference ``FuzzyJoinNormalization``: a feature appearing in cnt
    rows contributes weight(cnt) to a match (rare features dominate)."""

    WEIGHT = auto()
    LOGWEIGHT = auto()
    NONE = auto()

    @property
    def normalize(self) -> Callable[[float], float]:
        if self == FuzzyJoinNormalization.WEIGHT:
            return _discrete_weight
        if self == FuzzyJoinNormalization.LOGWEIGHT:
            return _discrete_logweight
        return lambda cnt: 1.0


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    left_column: Any = None,
    right_column: Any = None,
    threshold: float = 0.0,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
    by_hand_match: "Table | None" = None,
) -> Table:
    """Best-match pairs (left, right, weight): features from both sides,
    inverse-frequency weighting, greedy highest-weight-first matching
    (the reference's discipline).  ``by_hand_match`` rows (left, right,
    weight) are fixed first and excluded from fuzzy matching."""
    lcol = left_column if left_column is not None else left_table[left_table._column_names[0]]
    rcol = right_column if right_column is not None else right_table[right_table._column_names[0]]

    lpacked = left_table.reduce(
        rows=pw.reducers.tuple(
            pw.apply(lambda k, v: (k, v), left_table.id, lcol)
        )
    )
    rpacked = right_table.reduce(
        rows=pw.reducers.tuple(
            pw.apply(lambda k, v: (k, v), right_table.id, rcol)
        )
    )
    gen = feature_generation.generate
    norm = normalization.normalize

    def match(lrows, rrows, fixed):
        lrows = lrows or ()
        rrows = rrows or ()
        lfeat = {lk: gen(lv) for lk, lv in lrows}
        rfeat = {rk: gen(rv) for rk, rv in rrows}
        # global feature frequency over BOTH sides -> per-feature weight
        cnt: dict = {}
        for feats in list(lfeat.values()) + list(rfeat.values()):
            for f in feats:
                cnt[f] = cnt.get(f, 0) + 1
        w = {f: norm(c) for f, c in cnt.items()}
        used_l = {lk for lk, _rk, _w in fixed}
        used_r = {rk for _lk, rk, _w in fixed}
        # inverted index: only compare pairs sharing at least one feature
        by_feature: dict = {}
        for rk, feats in rfeat.items():
            for f in feats:
                by_feature.setdefault(f, []).append(rk)
        pairs = []
        for lk, feats in lfeat.items():
            cands: set = set()
            for f in feats:
                cands.update(by_feature.get(f, ()))
            for rk in cands:
                score = sum(w[f] for f in feats & rfeat[rk])
                if score > threshold:
                    pairs.append((score, lk, rk))
        pairs.sort(key=lambda p: (-p[0], str(p[1]), str(p[2])))
        out = list(fixed)
        for score, lk, rk in pairs:
            if lk in used_l or rk in used_r:
                continue
            used_l.add(lk)
            used_r.add(rk)
            out.append((lk, rk, score))
        return tuple(out)

    if by_hand_match is not None:
        hand = by_hand_match.reduce(
            fixed=pw.reducers.tuple(
                pw.apply(
                    lambda l, r, w: (l, r, float(w)),
                    by_hand_match.left,
                    by_hand_match.right,
                    by_hand_match.weight,
                )
            )
        )
        matches = (
            lpacked.join(rpacked)
            .select(rows=pw.left.rows, rrows=pw.right.rows)
            .join_left(hand)  # empty overrides table must NOT drop matches
            .select(
                pairs=pw.apply(
                    lambda lr, rr, f: match(lr, rr, list(f or ())),
                    pw.left.rows,
                    pw.left.rrows,
                    pw.right.fixed,
                )
            )
        )
    else:
        matches = lpacked.join(rpacked).select(
            pairs=pw.apply(lambda lr, rr: match(lr, rr, []), pw.left.rows, pw.right.rows)
        )
    flat = matches.flatten(matches.pairs)
    return flat.select(
        left=pw.apply(lambda p: p[0], flat.pairs),
        right=pw.apply(lambda p: p[1], flat.pairs),
        weight=pw.apply(lambda p: p[2], flat.pairs),
    )


def fuzzy_self_match(table: Table, column: Any = None, **kwargs: Any) -> Table:
    return fuzzy_match_tables(table, table, left_column=column, right_column=column, **kwargs)


smart_fuzzy_match = fuzzy_match_tables
