"""``pw.demo`` — synthetic streams (reference ``python/pathway/demo/``:
``generate_custom_stream`` ``:28``, ``noisy_linear_stream`` ``:118``,
``range_stream``, ``replay_csv``)."""

from __future__ import annotations

import random
import time as _time
from typing import Any, Callable, Mapping

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import DictSource, input_table

__all__ = [
    "generate_custom_stream",
    "noisy_linear_stream",
    "range_stream",
    "replay_csv",
    "replay_csv_with_time",
]


def generate_custom_stream(
    value_generators: Mapping[str, Callable[[int], Any]],
    *,
    schema: sch.SchemaMetaclass,
    nb_rows: int | None = None,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 20,
    persistent_id: str | None = None,
    name: str = "demo",
) -> Table:
    """Stream rows produced by per-column generator functions of the row
    index, at ``input_rate`` rows/sec (None ``nb_rows`` = infinite)."""

    def rows():
        i = 0
        delay = 1.0 / input_rate if input_rate > 0 else 0.0
        while nb_rows is None or i < nb_rows:
            yield {name_: gen(i) for name_, gen in value_generators.items()}
            i += 1
            if delay:
                _time.sleep(delay)

    src = DictSource(
        rows,
        schema,
        commit_interval=autocommit_duration_ms / 1000.0,
        commit_every=1 if input_rate <= 100 else 64,
        tag=name,
    )
    return input_table(src, schema, name=name)


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0, **kwargs: Any) -> Table:
    schema = sch.schema_from_types(x=float, y=float)
    rng = random.Random(0)

    return generate_custom_stream(
        {
            "x": lambda i: float(i),
            "y": lambda i: float(i) + (2 * rng.random() - 1) / 10,
        },
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        name="noisy_linear",
    )


def range_stream(
    nb_rows: int = 30, offset: int = 0, input_rate: float = 1.0, **kwargs: Any
) -> Table:
    schema = sch.schema_from_types(value=float)
    return generate_custom_stream(
        {"value": lambda i: float(i + offset)},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        name="range",
    )


def replay_csv(
    path: str,
    *,
    schema: sch.SchemaMetaclass,
    input_rate: float = 1.0,
    **kwargs: Any,
) -> Table:
    """Replay a CSV file as a stream at ``input_rate`` rows/sec."""
    import csv as _csv

    def rows():
        delay = 1.0 / input_rate if input_rate > 0 else 0.0
        with open(path) as f:
            for row in _csv.DictReader(f):
                yield dict(row)
                if delay:
                    _time.sleep(delay)

    src = DictSource(rows, schema, commit_every=1, tag=f"replay:{path}")
    return input_table(src, schema, name="replay_csv")


def replay_csv_with_time(
    path: str,
    *,
    schema: sch.SchemaMetaclass,
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1.0,
    **kwargs: Any,
) -> Table:
    """Replay a CSV using the recorded time column for pacing."""
    import csv as _csv

    scale = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]

    def rows():
        prev_t: float | None = None
        with open(path) as f:
            for row in _csv.DictReader(f):
                t = float(row[time_column]) * scale
                if prev_t is not None and t > prev_t:
                    _time.sleep((t - prev_t) / speedup)
                prev_t = t
                yield dict(row)

    src = DictSource(rows, schema, commit_interval=autocommit_ms / 1000.0, tag=f"replay:{path}")
    return input_table(src, schema, name="replay_csv_with_time")
