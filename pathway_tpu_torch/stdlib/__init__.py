"""stdlib: algorithms written against the Table API (counterpart of
``pathway_tpu/stdlib``, reference ``python/pathway/stdlib/``): temporal,
indexing, ml, graphs, stateful, statistical, ordered and utils.  ``viz``
comes with ROADMAP item 16 (slice 16e), and until then its name raises an
``AttributeError`` that says so."""

from typing import Any

#: submodules of ``pathway_tpu.stdlib`` that a later slice of the port brings
_LATER = ("viz",)


def __getattr__(name: str) -> Any:
    import importlib

    if name in ("temporal", "indexing", "ml", "graphs", "stateful", "statistical", "ordered", "utils"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _LATER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} yet: the port brings it with "
            "ROADMAP item 16 (slice 16e: sql, interactive, yaml_loader, demo, viz)"
        )
    raise AttributeError(name)
