"""Ring attention: sequence-parallel exact attention over the devices of
one mesh axis (counterpart of ``pathway_tpu/ops/ring_attention.py``).

The sequence dimension is cut into one block per device of the axis.
Each device keeps its query block and the flash state (o, m, l) of it,
and the K/V/mask blocks travel round the ring: on step ``s`` device ``i``
runs K14 (:func:`~pathway_tpu_torch.kernels.ring_block`) over the block
that started on device ``(i - s) mod n``, as ``_ring_body``'s ``ppermute``
(i -> i + 1) hands it on; the last step writes the normalised output.
The mesh is single-controller (:mod:`~pathway_tpu_torch.parallel.mesh`):
this process drives every device, and the hand-on is a copy to the next
device on side streams, started before the current step's launch, so
that on distinct cards the copy neither waits for the step's compute nor
holds it back.  On a mesh that repeats one device the copy is the
block itself.

Non-causal (encoder) attention with a key padding mask, as the JAX
module's.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import TYPE_CHECKING

import torch

from pathway_tpu_torch.kernels.attention import attention_plain
from pathway_tpu_torch.kernels.ring_block import ring_block, ring_block_plain, ring_state

if TYPE_CHECKING:
    from pathway_tpu_torch.parallel.mesh import Mesh

__all__ = ["local_attention", "ring_attention", "ring_attention_plain", "ring_attention_blocks"]

Blocks = Sequence[torch.Tensor]


def local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain single-device attention.  q/k/v: ``[B, L, H, D]``; mask:
    ``[B, L]`` (key positions)."""
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.uint8, device=q.device)
    return attention_plain(q, k, v, mask)


#: the side stream of each card that copies K/V blocks, made once: the
#: caching allocator keeps a pool per stream, so a new stream per call
#: would allocate every copied block afresh
_SIDE: dict = {}


def _side(device: torch.device):
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def _hand_on(block: tuple, ready, device: torch.device) -> tuple[tuple, object]:
    """Start the copy of one K/V/mask block to ``device``; returns (the
    block on ``device``, the event that marks its arrival there, or None
    when it was made there).

    ``ready`` is the event of the copy that brought the block to its
    current device (None when the block was made there).  The copy runs
    on side streams of both devices: PyTorch issues a copy between cards
    on the source's current stream and makes the destination's current
    stream wait for it, so with the side streams current on both it
    waits neither for the step running on the source nor holds back the
    destination's.  It starts once the block is complete: behind the work
    queued on the source's own stream when the block was made there,
    behind ``ready`` when it arrived by an earlier copy."""
    src = block[0].device
    if src == device:
        return block, ready
    if device.type != "cuda" or src.type != "cuda":
        return tuple(t.to(device) for t in block), None
    out_side, in_side = _side(src), _side(device)
    if ready is None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src))
    out_side.wait_event(ready)
    with torch.cuda.stream(out_side), torch.cuda.stream(in_side):
        moved = tuple(t.to(device, non_blocking=True) for t in block)
    for t in block:  # not reused before the copy has read it
        t.record_stream(out_side)
    done = torch.cuda.Event()
    done.record(in_side)
    consumer = torch.cuda.current_stream(device)
    for t in moved:  # freed only after the consumer's use
        t.record_stream(consumer)
    return moved, done


def ring_attention_blocks(
    qs: Blocks, ks: Blocks, vs: Blocks, masks: Blocks, step: Callable = ring_block
) -> list[torch.Tensor]:
    """The ring over per-device blocks: ``qs[i]``, ``ks[i]``, ``vs[i]``
    ``[B, Lb, H, D]`` and ``masks[i]`` ``[B, Lb]`` uint8 on device ``i``
    (devices may repeat).  ``step`` is K14 or its plain version.  Returns
    the output blocks, block ``i`` on device ``i``."""
    n = len(qs)
    devices = [q.device for q in qs]
    B, Lb, H, D = qs[0].shape
    states = [ring_state(B, Lb, H, D, dev) for dev in devices]
    cur = [((ks[i], vs[i], masks[i]), None) for i in range(n)]
    outs: list = [None] * n
    for s in range(n):
        last = s == n - 1
        # the blocks of step s + 1, copied while step s runs: device i takes
        # the one device i - 1 holds now
        nxt = None if last else [_hand_on(*cur[(i - 1) % n], devices[i]) for i in range(n)]
        for i in range(n):
            (k, v, mask), ready = cur[i]
            if ready is not None:
                torch.cuda.current_stream(devices[i]).wait_event(ready)
            outs[i] = step(qs[i], k, v, mask, *states[i], finalize=last)
        cur = nxt
    return outs


def _run(q, k, v, mask, mesh: "Mesh", axis: str, step: Callable):
    if isinstance(q, torch.Tensor):
        devices = mesh.devices_along(axis)
        n = len(devices)
        if q.shape[1] % n:
            raise ValueError(f"ring_attention: sequence length {q.shape[1]} must divide by {n}")
        if mask is None:
            mask = torch.ones(q.shape[:2], dtype=torch.uint8, device=q.device)
        mask = mask.to(torch.uint8)

        def split(t: torch.Tensor) -> list[torch.Tensor]:
            return [c.to(d).contiguous() for c, d in zip(t.chunk(n, dim=1), devices)]

        outs = ring_attention_blocks(split(q), split(k), split(v), split(mask), step)
        return torch.cat([o.to(q.device) for o in outs], dim=1)
    n = mesh.shape[axis]
    if len(q) != n:
        raise ValueError(f"ring_attention: {len(q)} blocks for a {axis!r} axis of {n} devices")
    if mask is None:
        mask = [torch.ones(b.shape[:2], dtype=torch.uint8, device=b.device) for b in q]
    return ring_attention_blocks(q, k, v, mask, step)


def ring_attention(q, k, v, mask=None, *, mesh: "Mesh", axis: str = "data"):
    """Exact attention with the sequence dimension spread over ``axis``,
    through K14.

    Either global ``[B, L, H, D]`` q/k/v and ``[B, L]`` mask (L divisible
    by the axis size; cut into blocks, block ``i`` copied to device ``i``
    of the axis, the output gathered back on q's device), or lists of the
    per-device blocks (the output is the list of blocks)."""
    return _run(q, k, v, mask, mesh, axis, ring_block)


def ring_attention_plain(q, k, v, mask=None, *, mesh: "Mesh", axis: str = "data"):
    """:func:`ring_attention` through the plain version of K14."""
    return _run(q, k, v, mask, mesh, axis, ring_block_plain)
