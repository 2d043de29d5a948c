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
of the kernel per device over a table of the tensors, for CPU tensors
:func:`adam_step_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import launch

__all__ = ["adam_step", "adam_step_plain", "adam_constants", "B1", "B2", "EPS", "CHUNK"]

#: optax.adam's defaults, the reference's (eps_root 0)
B1, B2, EPS = 0.9, 0.999, 1e-8
#: values a block of the kernel updates
CHUNK = 1 << 16


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


def _table(device: torch.device, group: list[tuple[torch.Tensor, ...]]) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's tensor table (four pointers and a length each) and its
    chunk list (tensor index, chunk index), on ``device``."""
    rows = [[t.data_ptr() for t in ts] + [ts[0].numel()] for ts in group]
    chunks = [(i, c) for i, ts in enumerate(group) for c in range(-(-ts[0].numel() // CHUNK))]
    table = torch.tensor(rows, dtype=torch.int64).to(device)
    order = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2).to(device)
    return table, order


def adam_step(
    params: list[torch.Tensor], grads: list[torch.Tensor], exp_avgs: list[torch.Tensor],
    exp_avg_sqs: list[torch.Tensor], step: int, lr: float,
) -> None:
    """One Adam step in place; ``step`` counts this one (1 on the first)."""
    if not params:
        return
    if params[0].device.type == "cpu":
        return adam_step_plain(params, grads, exp_avgs, exp_avg_sqs, step, lr)
    groups: dict[torch.device, list] = {}
    for ts in zip(params, grads, exp_avgs, exp_avg_sqs):
        devs = {t.device for t in ts}
        if len(devs) != 1 or ts[0].device.type != "cuda":
            raise ValueError(f"adam: a parameter and its state on {sorted(map(str, devs))}, want one CUDA device")
        if any(t.dtype != torch.float32 or not t.is_contiguous() or t.shape != ts[0].shape for t in ts):
            raise ValueError("adam: parameters, gradients and moments must be contiguous f32 of one shape")
        groups.setdefault(ts[0].device, []).append(ts)
    c = adam_constants(step, lr)
    for device, group in groups.items():
        table, order = _table(device, group)
        launch(
            "adam", _build.library("adam").pw_adam, device,
            table.data_ptr(), order.data_ptr(), order.shape[0], CHUNK,
            *(float(c[k]) for k in ("b1", "b2", "one_minus_b1", "one_minus_b2", "bc1", "bc2", "eps", "neg_lr")),
        )
        adam_step.launches += 1


#: launches of the CUDA kernel in this process (one a step and device)
adam_step.launches = 0
