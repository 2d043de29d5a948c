"""Loader for the C++ host-runtime extension (``pathway_tpu_torch/native/``).

Compiles the package's own ``native/pathway_native.cpp`` with g++ on
first use (cached under ``native/build/`` in the package) and exposes it
as the module ``pathway_torch_native``, a name of its own so that it is
never mixed up with the JAX package's ``pathway_native`` in one process;
every caller has a Python fallback, and ``PATHWAY_DISABLE_NATIVE=1``
forces it.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading
from typing import Any

_logger = logging.getLogger("pathway_tpu_torch.native")
_lock = threading.Lock()
_module: Any = None
_tried = False

#: the extension module's name (``PyInit_pathway_torch_native`` in the source)
MODULE_NAME = "pathway_torch_native"
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_ROOT, "native", "pathway_native.cpp")
_BUILD_DIR = os.path.join(_PKG_ROOT, "native", "build")


def _compile() -> str | None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"{MODULE_NAME}.so")
    # cross-PROCESS build lock + atomic rename: spawned cluster workers
    # all race through here on a cold cache; without it two g++ runs write
    # the same .so and a third process dlopens the torn file
    lock_path = so_path + ".lock"
    import contextlib

    @contextlib.contextmanager
    def _build_lock():
        try:
            import fcntl

            with open(lock_path, "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)
        except ImportError:  # non-POSIX: best effort, rename is still atomic
            yield

    with _build_lock():
        if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
            return so_path
        include = sysconfig.get_paths()["include"]
        tmp_path = f"{so_path}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
            "-std=c++17", f"-I{include}", _SRC, "-o", tmp_path,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, so_path)
        except Exception as e:  # noqa: BLE001
            _logger.info("native build skipped: %r", e)
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            return None
        return so_path


def load() -> Any:
    """The compiled module, or None (fallback to Python paths)."""
    global _module, _tried
    if _module is not None or _tried:
        return _module
    with _lock:
        if _module is not None or _tried:
            return _module
        _tried = True
        if os.environ.get("PATHWAY_DISABLE_NATIVE") == "1":
            return None
        if not os.path.exists(_SRC):
            return None
        so_path = _compile()
        if so_path is None or not os.path.exists(so_path):
            return None
        try:
            spec = importlib.util.spec_from_file_location(MODULE_NAME, so_path)
            assert spec is not None and spec.loader is not None
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as e:  # noqa: BLE001
            _logger.info("native load failed: %r", e)
            return None
        # register the value classes the VM needs for type-tagged
        # hashing (Pointer) and Json get/convert semantics.  Local
        # imports: keys/json import this module at top level.
        try:
            from pathway_tpu_torch.internals.json import Json
            from pathway_tpu_torch.internals.keys import Pointer

            mod.set_pointer_type(Pointer)
            mod.set_json_type(Json)
            from pathway_tpu_torch.engine.stream import Update

            mod.set_update_type(Update)
            mod._json_registered = True
        except Exception:  # registration failure only disables fast paths
            mod._json_registered = False
        _module = mod
        return mod
