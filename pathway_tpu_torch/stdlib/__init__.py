"""stdlib: algorithms written against the Table API (counterpart of
``pathway_tpu/stdlib``, reference ``python/pathway/stdlib/``).

The port has ``indexing`` (ROADMAP item 14) and ``utils`` (item 15);
temporal, ml, graphs, stateful, statistical, ordered and viz come with
item 16, and until then their names raise an ``AttributeError`` that
says so."""

from typing import Any

#: submodules of ``pathway_tpu.stdlib`` that a later slice of the port brings
_LATER = ("temporal", "ml", "graphs", "stateful", "statistical", "ordered", "viz")


def __getattr__(name: str) -> Any:
    import importlib

    if name in ("indexing", "utils"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _LATER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} yet: the port brings it with "
            "ROADMAP item 16 (slice 16d: stdlib beyond indexing)"
        )
    raise AttributeError(name)
