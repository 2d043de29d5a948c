"""Temporal behaviors (reference
``stdlib/temporal/temporal_behavior.py:21-100``)."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Behavior", "CommonBehavior", "ExactlyOnceBehavior", "common_behavior", "exactly_once_behavior"]


class Behavior:
    pass


@dataclasses.dataclass
class CommonBehavior(Behavior):
    """delay: buffer rows until watermark >= window_start + delay;
    cutoff: freeze/forget at window_end + cutoff;
    keep_results: whether closed windows' results stay in the output."""

    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay: Any = None, cutoff: Any = None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclasses.dataclass
class ExactlyOnceBehavior(Behavior):
    """Each window produces exactly one output, shift after it closes
    (reference ``exactly_once_behavior``)."""

    shift: Any = None


def exactly_once_behavior(shift: Any = None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)
