"""Extension packs of the port (reference ``python/pathway/xpacks/``;
counterpart of ``pathway_tpu/xpacks/__init__.py``): ``llm`` resolves
lazily."""

from typing import Any


def __getattr__(name: str) -> Any:
    import importlib

    if name in ("llm",):
        return importlib.import_module(f"pathway_tpu_torch.xpacks.{name}")
    raise AttributeError(name)
