"""stdlib: algorithms written against the Table API (counterpart of
``pathway_tpu/stdlib``, reference ``python/pathway/stdlib/``): temporal,
indexing, ml, graphs, stateful, statistical, ordered, utils and viz."""

from typing import Any


def __getattr__(name: str) -> Any:
    import importlib

    if name in ("temporal", "indexing", "ml", "graphs", "stateful", "statistical", "ordered", "utils", "viz"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
