"""K19: one Adam step over every parameter in one launch
(``csrc/adam.cu``).

Replaces ``optax.adam(1e-4)``'s update and ``optax.apply_updates`` in the
train step, ``__graft_entry__.py:126-131``, in optax's arithmetic and
order, all in f32::

    m = (1 - b1) g + b1 m;   v = (1 - b2) g^2 + b2 v
    p = p + (-lr) * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps))

with b1, b2, eps optax's defaults (:data:`B1`, :data:`B2`, :data:`EPS`),
``t`` the step count after its increment (an int, as optax's int32
count), each product and sum rounded on its own.  ``1 - b1`` and
``1 - b2`` are the double differences rounded to f32, as optax's weakly
typed constants are; the bias corrections ``1 - b^t`` are taken in f32.
(``torch.optim.Adam`` orders its denominator differently.)

:func:`adam_step` updates ``params``, ``exp_avgs`` (m) and
``exp_avg_sqs`` (v) in place from ``grads``: for CUDA tensors one launch
of the kernel per device, for CPU tensors :func:`adam_step_plain`.  The
kernel walks equal spans of :data:`UNIT` values (:func:`work_plan`), 16-byte
vectors over each tensor's aligned body; the table of p, m and v pointers
and the span list are built once for a parameter set and kept on the card
(rebuilt when a pointer or a size changes), and the gradients' pointers
ride in the launch's parameters: a step copies nothing from the host.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from collections.abc import Sequence

import numpy as np
import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import launch

__all__ = ["adam_step", "adam_step_plain", "adam_constants", "work_plan", "B1", "B2", "EPS", "UNIT", "MAX_TENSORS"]

#: optax.adam's defaults, the reference's (eps_root 0)
B1, B2, EPS = 0.9, 0.999, 1e-8
#: values of a span, the kernel's unit of work (16 KB of each stream)
UNIT = 4096
#: tensors one launch takes: their gradients' pointers ride in the launch's
#: parameters (``csrc/adam.cu``'s kMaxTensors)
MAX_TENSORS = 1024
#: parameter sets whose tables stay on the card
_PLANS_KEPT = 8


def adam_constants(step: int, lr: float) -> dict[str, np.float32]:
    """The step's f32 constants as optax computes them."""
    f = np.float32
    return {
        "b1": f(B1), "b2": f(B2), "one_minus_b1": f(1 - B1), "one_minus_b2": f(1 - B2),
        "bc1": f(1) - f(B1) ** f(step), "bc2": f(1) - f(B2) ** f(step), "eps": f(EPS), "neg_lr": f(-lr),
    }


@torch.no_grad()
def adam_step_plain(
    params: list[torch.Tensor], grads: list[torch.Tensor], exp_avgs: list[torch.Tensor],
    exp_avg_sqs: list[torch.Tensor], step: int, lr: float,
) -> None:
    c = {k: torch.tensor(v) for k, v in adam_constants(step, lr).items()}
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        m.copy_(c["one_minus_b1"] * g + c["b1"] * m)
        v.copy_(c["one_minus_b2"] * (g * g) + c["b2"] * v)
        u = (m / c["bc1"]) / (torch.sqrt(v / c["bc2"]) + c["eps"])
        p.copy_(p + c["neg_lr"] * u)


def work_plan(tensors: Sequence[tuple[int, int, int, int]]) -> np.ndarray:
    """The kernel's spans for f32 tensors given as ``(numel, address of p,
    of m, of v)``: an int64 array ``[n_spans, 3]`` of (tensor, start,
    count), each span up to :data:`UNIT` values.  ``count > 0``: a vector
    span (count a multiple of 4, every address + 4 * start 16-byte
    aligned); ``count < 0``: ``-count`` values taken one at a time.  A
    tensor whose p, m and v are aligned alike is a scalar head (before p is
    16-byte aligned), vector spans over its body and a scalar tail of fewer
    than 4 values; any other tensor is scalar spans only."""
    parts = []
    for i, (n, *addrs) in enumerate(tensors):
        if n == 0:
            continue
        if len({a % 16 for a in addrs}) == 1 and addrs[0] % 4 == 0:
            head = min(n, (16 - addrs[0] % 16) % 16 // 4)
            body = (n - head) // 4 * 4
            starts = np.arange(head, head + body, UNIT, dtype=np.int64)
            counts = np.minimum(UNIT, head + body - starts)
            edges = [(0, head), (head + body, n - head - body)]
        else:
            starts = np.arange(0, n, UNIT, dtype=np.int64)
            counts = -np.minimum(UNIT, n - starts)
            edges = []
        rows = [np.stack([np.full_like(starts, i), starts, counts], axis=1)]
        rows += [np.array([[i, at, -count]], dtype=np.int64) for at, count in edges if count]
        parts.extend(rows)
    return np.concatenate(parts) if parts else np.zeros((0, 3), dtype=np.int64)


#: (device, pointers and sizes) -> the tensor table and the packed spans on
#: the card, most recent last
_plans: OrderedDict = OrderedDict()


def _plan_on_card(device: torch.device, ps: list, ms: list, vs: list) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's table of p, m, v pointers and its span list (``Span``:
    start int64, tensor int32, count int32) for these tensors on
    ``device``; checked, built and uploaded when their pointers or sizes
    are new (a plan is kept by them)."""
    key = (device, tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel()) for p, m, v in zip(ps, ms, vs)))
    hit = _plans.get(key)
    if hit is not None:
        _plans.move_to_end(key)
        return hit
    for ts in zip(ps, ms, vs):
        if any(t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or t.shape != ts[0].shape
               for t in ts):
            raise ValueError(f"adam: a parameter and its moments must be contiguous f32 of one shape on {device}, "
                             f"got {[(str(t.device), t.dtype, tuple(t.shape)) for t in ts]}")
    plan = work_plan([(n, a, b, c) for a, b, c, n in key[1]])
    packed = np.zeros((plan.shape[0], 2), dtype=np.int64)
    packed[:, 0] = plan[:, 1]
    words = packed.view(np.int32)  # little-endian: [start lo, start hi, tensor, count]
    words[:, 2] = plan[:, 0]
    words[:, 3] = plan[:, 2]
    table = torch.tensor([row[:3] for row in key[1]], dtype=torch.int64).reshape(-1, 3).to(device)
    spans = torch.from_numpy(packed).to(device)
    _plans[key] = (table, spans)
    while len(_plans) > _PLANS_KEPT:
        _plans.popitem(last=False)
    return table, spans


def adam_step(
    params: list[torch.Tensor], grads: list[torch.Tensor], exp_avgs: list[torch.Tensor],
    exp_avg_sqs: list[torch.Tensor], step: int, lr: float,
) -> None:
    """One Adam step in place; ``step`` counts this one (1 on the first)."""
    if not params:
        return
    if params[0].device.type == "cpu":
        return adam_step_plain(params, grads, exp_avgs, exp_avg_sqs, step, lr)
    if not len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(params):
        raise ValueError("adam: one gradient, m and v for each parameter")
    groups: dict[torch.device, list] = {}
    for ts in zip(params, grads, exp_avgs, exp_avg_sqs):
        groups.setdefault(ts[0].device, []).append(ts)
    c = adam_constants(step, lr)
    for device, group in groups.items():
        if len(group) > MAX_TENSORS:
            raise ValueError(f"adam: {len(group)} tensors on {device}; one launch takes at most {MAX_TENSORS} "
                             f"(their gradients' pointers ride in the launch's parameters)")
        if device.type != "cuda":
            raise ValueError(f"adam: parameters on {device}, want a CUDA device")
        ps, gs, ms, vs = (list(t) for t in zip(*group))
        for g, p in zip(gs, ps):
            if g.device != device or g.dtype != torch.float32 or not g.is_contiguous() or g.shape != p.shape:
                raise ValueError(f"adam: a gradient on {g.device}, {g.dtype} {tuple(g.shape)}, want contiguous "
                                 f"f32 of its parameter's shape {tuple(p.shape)} on {device}")
        table, spans = _plan_on_card(device, ps, ms, vs)
        grad_ptrs = (ctypes.c_void_p * len(gs))(*[g.data_ptr() for g in gs])
        launch(
            "adam", _build.library("adam").pw_adam, device,
            table.data_ptr(), spans.data_ptr(), spans.shape[0], grad_ptrs, len(gs),
            *(float(c[k]) for k in ("b1", "b2", "one_minus_b1", "one_minus_b2", "bc1", "bc2", "eps", "neg_lr")),
        )
        adam_step.launches += 1


#: launches of the CUDA kernel in this process (one a step and device)
adam_step.launches = 0
