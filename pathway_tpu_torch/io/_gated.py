"""Helper for service-backed connectors whose client libraries may not be
installed: expose the reference API shape, fail with a clear message at
call time (not import time).

Counterpart of ``pathway_tpu/io/_gated.py``: the same host code over the port's engine.
"""

from __future__ import annotations

from typing import Any, Callable


class MissingDependency(ImportError):
    pass


def require(*candidates: str) -> Any:
    """Import the first available client module or raise MissingDependency."""
    import importlib

    errors = []
    for name in candidates:
        try:
            return importlib.import_module(name)
        except ImportError as e:
            errors.append(str(e))
    raise MissingDependency(
        f"none of the client libraries {candidates} are installed in this "
        "environment; this connector keeps the reference API surface and "
        "activates when a client is available"
    )


def gated_reader(connector: str, *deps: str) -> Callable:
    def read(*args: Any, **kwargs: Any) -> Any:
        require(*deps)
        raise NotImplementedError(
            f"pw.io.{connector}.read: client available but integration not wired"
        )

    return read


def gated_writer(connector: str, *deps: str) -> Callable:
    def write(*args: Any, **kwargs: Any) -> Any:
        require(*deps)
        raise NotImplementedError(
            f"pw.io.{connector}.write: client available but integration not wired"
        )

    return write
