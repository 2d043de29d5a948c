"""Device meshes (counterpart of ``pathway_tpu/parallel/mesh.py``).

Conventions, as in the JAX package:

- axis ``"data"``: batch and corpus sharding (data parallelism and index
  shards);
- axis ``"model"``: tensor parallelism inside encoders;
- an encoder's ``sequence_axis`` (often ``"data"``): sequence
  parallelism, ring attention over the sequence blocks.

The JAX package is single-controller: one ``jax.sharding.Mesh`` over
``jax.devices()``, driven by one Python caller.  The port keeps that
model: a :class:`Mesh` is a named grid of ``torch.device`` objects, and
the object that takes it (``ShardedKnnIndex(mesh=)``,
``TorchEncoder(mesh=)``) drives every device of it from one process,
copying between cards where the JAX program runs a collective.  No
process group is involved.

Deliberate deviation: a mesh may name one device more than once.  That
plays the part of XLA's ``--xla_force_host_platform_device_count`` for
the JAX package's tests: ``make_mesh({"data": 8}, ["cpu"] * 8)`` runs an
8-shard index on the CPU, and ``make_mesh({"data": 4}, ["cuda:0"] * 4)``
a 4-shard index on one card.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device

__all__ = [
    "Mesh", "make_mesh", "best_mesh", "mesh_axis_size", "data_devices", "encoder_grids",
    "MODEL_AXIS",
]

#: the axis tensor parallelism splits heads and MLP width over
MODEL_AXIS = "model"


class Mesh:
    """``devices``: an array of ``torch.device`` shaped by the axes;
    ``axis_names``: the axes in order; ``shape``: ``{axis: size}`` in
    order, as ``jax.sharding.Mesh.shape`` gives it."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def devices_along(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        at = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[at].reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def _default_devices() -> list[torch.device]:
    """Every CUDA device; raises when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axes: dict[str, int] | None = None, devices: Sequence[str | torch.device] | None = None
) -> Mesh:
    """A :class:`Mesh` from ``{axis: size}``; the sizes must multiply to
    ``len(devices)``.  Default: 1-D ``("data",)`` over every CUDA device."""
    devs = [resolve_device(d) for d in devices] if devices is not None else _default_devices()
    if axes is None:
        axes = {"data": len(devs)}
    shape = tuple(axes.values())
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh axes {axes} need {math.prod(shape)} devices, have {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axes))


def best_mesh(
    model_parallel: int = 1, devices: Sequence[str | torch.device] | None = None
) -> Mesh:
    """2-D ``("data", "model")`` mesh with the requested TP degree, clamped
    to a divisor of the device count."""
    devs = list(devices) if devices is not None else _default_devices()
    n = len(devs)
    mp = max(1, model_parallel)
    while n % mp != 0:
        mp -= 1
    return make_mesh({"data": n // mp, "model": mp}, devs)


def mesh_axis_size(mesh: Mesh | None, axis: str) -> int:
    if mesh is None or axis not in mesh.shape:
        return 1
    return mesh.shape[axis]


def encoder_grids(
    mesh: Mesh, data_axis: str = "data", sequence_axis: str | None = None,
    model_axis: str = MODEL_AXIS, user: str = "TorchEncoder",
) -> list[list[list[torch.device]]]:
    """The device grids an encoder runs on, one per data-parallel replica:
    row ``b`` of a grid runs block ``b`` of the sequence (the devices
    along ``sequence_axis``; one row without it), column ``j`` model shard
    ``j`` (along ``model_axis``).  With a sequence axis the batch is not
    split (the JAX executor then shards only the sequence): one grid.
    Without, one grid per device along ``data_axis``.  An axis the mesh
    lacks has size 1; any other axis larger than 1 raises."""
    if sequence_axis is not None and sequence_axis == model_axis:
        raise ValueError(f"{user}: sequence axis {sequence_axis!r} is the model axis")
    used = {data_axis, model_axis} | ({sequence_axis} if sequence_axis else set())
    wide = {a: n for a, n in mesh.shape.items() if a not in used and n > 1}
    if wide:
        raise NotImplementedError(f"{user}: mesh axes {wide} besides {sorted(used)}")
    n_data = 1 if sequence_axis else mesh.shape.get(data_axis, 1)
    n_seq = mesh.shape.get(sequence_axis, 1) if sequence_axis else 1
    n_tp = mesh.shape.get(model_axis, 1)

    def at(r: int, b: int, j: int) -> torch.device:
        pos = {sequence_axis: b, model_axis: j} if sequence_axis else {data_axis: r, model_axis: j}
        return mesh.devices[tuple(pos.get(a, 0) for a in mesh.axis_names)]

    return [[[at(r, b, j) for j in range(n_tp)] for b in range(n_seq)] for r in range(n_data)]


def data_devices(mesh: Mesh, data_axis: str, user: str) -> list[torch.device]:
    """The devices ``user`` spreads its data over: those along
    ``data_axis`` at index 0 of the ``"model"`` axis (data are replicated
    over the model shards); the first device when the mesh lacks
    ``data_axis``.  Any other axis larger than 1 raises."""
    return [grid[0][0] for grid in encoder_grids(mesh, data_axis, user=user)]
