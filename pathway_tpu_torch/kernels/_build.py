"""Build the port's CUDA kernels from ``kernels/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  A library
is loaded as a ``ctypes.PyDLL``: its functions only check arguments and
enqueue work on a stream, so a call keeps the GIL instead of releasing
and taking it back around every launch.  Libraries
go into ``kernels/_build/`` (git-ignored), named by a hash of their
source, of the shared headers (``csrc/*.cuh``) and of the constants a
source takes from its wrapper as ``-D`` flags, so an edited source is
rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ast
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NAMES", "build_all", "library", "ptxas_report"]

NAMES = (
    "attention", "slab_scatter", "knn_topk",
    "bias_act", "add_layer_norm", "embed_ln", "pool_normalize",
    "patchify", "vision_head", "dual_logits",
    "ivf_assign", "ivf_scan", "topk_select", "ring_block",
    "attention_bwd", "bias_act_bwd", "layer_norm_bwd", "contrastive_loss", "adam",
)

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ptxas: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are built from kernels/csrc at first use"
    )


#: constants a source takes from its wrapper module as ``-D`` flags: K15's
#: cluster-form limits, which ``attention.bwd_form`` also reads
_DEFINES = {"attention_bwd": ("attention.py", ("BWD_CLUSTER_MAX_LEN", "BWD_CLUSTER_MAX_HEAD_DIM"))}


def _defines(name: str) -> list[str]:
    """``-DPW_<NAME>=<value>`` for each constant ``name`` takes, read from
    the wrapper's source beside this file rather than imported, so that a
    copy of these modules loaded by path (another commit's) builds with its
    own wrapper's numbers."""
    if name not in _DEFINES:
        return []
    module, wanted = _DEFINES[name]
    tree = ast.parse((Path(__file__).resolve().parent / module).read_text())
    values = {t.id: node.value.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name) and t.id in wanted}
    return [f"-DPW_{key}={values[key]}" for key in wanted]


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes() + _ARCH.encode())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    for flag in _defines(name):
        digest.update(flag.encode())
    return _BUILD / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=NAMES) -> None:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all at once; load them."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo", *_defines(name),
                "-o", str(tmp), str(_CSRC / f"{name}.cu"),
            ]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            _ptxas[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            _libs[name] = _declare(name, ctypes.PyDLL(str(_target(name))))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v`` output of this process's build of ``name``
    (empty when the library was already built)."""
    return _ptxas.get(name, "")


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

_SIGNATURES = {
    "attention": {"pw_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]},
    "slab_scatter": {
        "pw_slab_scatter": [_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _P],
        "pw_slab_clear": [_P, _P, _I, _LL, _P],
    },
    "knn_topk": {
        "pw_knn_partial": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _LL, _P],
        "pw_knn_partial_tiled": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _LL, _I, _P],
        "pw_knn_merge": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "bias_act": {"pw_bias_act": [_P, _P, _P, _I, _LL, _I, _I, _I, _P]},
    "add_layer_norm": {"pw_add_layer_norm": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P]},
    "embed_ln": {
        "pw_embed_ln": [_P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    },
    "pool_normalize": {"pw_pool_normalize": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "patchify": {"pw_patchify": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "vision_head": {"pw_vision_head": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]},
    "dual_logits": {"pw_dual_logits": [_P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "ivf_assign": {"pw_ivf_assign": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "ivf_scan": {
        "pw_ivf_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "pw_ivf_scan_cells_plan": [_I, _I, _I, _I, _I, _LL, ctypes.POINTER(_LL)],
        "pw_ivf_scan_cells": [_P] * 9 + [_I] * 7 + [_P],
    },
    "topk_select": {
        "pw_topk_select": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _P],
        "pw_topk_select_launches": [],
    },
    "ring_block": {
        "pw_ring_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    "attention_bwd": {"pw_attention_bwd": [_P] * 11 + [_I, _I, _I, _I, _F, _I, _P]},
    "bias_act_bwd": {"pw_bias_act_bwd": [_P] * 6 + [_I, _I, _I, _I, _P], "pw_bias_sum": [_P, _P, _I, _I, _P]},
    "layer_norm_bwd": {
        "pw_layer_norm_bwd_grid": [_I, _I],
        "pw_layer_norm_bwd": [_P] * 8 + [_I, _I, _F, _I, _P],
        "pw_embed_ln_bwd": [_P, _I, _P, _I, _P, _I, _P, _I, _P] + [_I] * 5 + [_P] * 10 + [_I, _F, _I, _P],
    },
    "contrastive_loss": {
        "pw_contrastive_loss": [_P, _P, _P, _I, _F, _F, _P],
        "pw_pool_normalize_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "adam": {"pw_adam": [_P, _P, _I, _P, _I] + [_F] * 8 + [_P]},
}


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
