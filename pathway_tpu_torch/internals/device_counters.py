"""Live device-plane counters: host<->device bytes of the port.

Counterpart of ``pathway_tpu/internals/device_counters.py``.  The
``h2d_bytes`` / ``d2h_bytes`` counters are recorded at the port's own
transfer call sites (``parallel/executor.py`` chunk uploads and
readbacks, ``parallel/sharded_knn.py`` dispatch/collect and host
ingest, ``parallel/ivf_knn.py`` search, ingest and training uploads and
the search readback): PyTorch, like jax, has no public per-transfer
hook, so these count the transfers the port issues.

The JAX package also counts XLA backend compiles through a
``jax.monitoring`` listener.  That counter has no counterpart here:
PyTorch runs eagerly and the port compiles nothing per shape (its
kernels are built once, at first use, by ``kernels/_build.py``).  What
shows that the main path ran through the port's own kernels is the
launch count on each kernel wrapper (``kernels.launch_counts``).
"""

from __future__ import annotations

import threading

__all__ = ["record_h2d", "record_d2h", "snapshot", "reset_for_tests"]

_lock = threading.Lock()

# monotonic counters; ints under the GIL, guarded anyway for += races
_counters: dict[str, int] = {
    "h2d_bytes": 0,
    "h2d_transfers": 0,
    "d2h_bytes": 0,
    "d2h_transfers": 0,
}


def _bump(key: str, amount: int) -> None:
    with _lock:
        _counters[key] += amount


def record_h2d(nbytes: int) -> None:
    """Count one host->device upload of ``nbytes``."""
    _bump("h2d_bytes", int(nbytes))
    _bump("h2d_transfers", 1)


def record_d2h(nbytes: int) -> None:
    """Count one device->host readback of ``nbytes``."""
    _bump("d2h_bytes", int(nbytes))
    _bump("d2h_transfers", 1)


def snapshot() -> dict[str, int]:
    """Point-in-time copy of all counters."""
    with _lock:
        return dict(_counters)


def reset_for_tests() -> None:
    """Zero the counters."""
    with _lock:
        for k in _counters:
            _counters[k] = 0
