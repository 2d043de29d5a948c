"""K6: fused embedding gather + sum + LayerNorm (``csrc/embed_ln.cu``).

Replaces ``Embeddings.__call__``, ``pathway_tpu/models/encoder.py:152-176``,
in flax's order: every table is cast to the activation type before its
gather, ``e = word[id] + position[l]`` and then ``e + type[t]`` (when the
config has a type vocabulary) are each rounded to it, and the sum goes
through LayerNorm as in K5.  Word and type ids out of range give flax
``nn.Embed``'s result (``jnp.take`` with ``mode="fill"``): an id in
``[-n, 0)`` wraps to ``n + id``; an id ``>= n`` or ``< -n`` gives a NaN
embedding row, so a NaN output row.

:func:`embed_ln` returns ``[B, L, H]`` in ``dtype``.  For CUDA tensors it
launches the kernel (bf16 output; ids as int16, int32 or int64 and type
ids as uint8 or an int type, read as uploaded; f32 tables) and raises on
anything else; for CPU tensors it runs :func:`embed_ln_plain`.
``type_ids=None`` means zeros; ``type_table=None`` means the config has
no type vocabulary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.kernels.add_layer_norm import check_norm_params, layer_norm_plain

__all__ = ["embed_ln", "embed_ln_plain"]

#: index dtype -> the kernel's code for it
_INDEX_KINDS = {torch.uint8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4}


def _gather(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``table.astype(dtype)[ids]`` as flax's ``nn.Embed`` takes it."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    outside = (ids < 0) | (ids >= n)
    rows = F.embedding(ids.clamp(0, n - 1), table).to(dtype)
    return rows.masked_fill(outside[..., None], float("nan"))


def embed_ln_plain(
    ids: torch.Tensor, type_ids: torch.Tensor | None, word: torch.Tensor,
    position: torch.Tensor, type_table: torch.Tensor | None, scale: torch.Tensor,
    bias: torch.Tensor, eps: float, dtype: torch.dtype,
) -> torch.Tensor:
    # ids may arrive narrowed (int16): F.embedding takes int64
    ids = ids.long()
    emb = _gather(word, ids, dtype)
    emb = emb + position[: ids.shape[1]].to(dtype)[None]
    if type_table is not None:
        t = torch.zeros_like(ids) if type_ids is None else type_ids.long()
        emb = emb + _gather(type_table, t, dtype)
    return layer_norm_plain(emb, scale, bias, eps)


def embed_ln(
    ids: torch.Tensor, type_ids: torch.Tensor | None, word: torch.Tensor,
    position: torch.Tensor, type_table: torch.Tensor | None, scale: torch.Tensor,
    bias: torch.Tensor, eps: float, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """LayerNorm(word[ids] + position[:L] (+ type[type_ids])) -> ``[B, L, H]``;
    the kernel on a card, the plain version for CPU tensors."""
    if ids.device.type == "cpu":
        return embed_ln_plain(ids, type_ids, word, position, type_table, scale, bias, eps, dtype)
    tables = {"word": word, "position": position, "scale": scale, "bias": bias}
    if type_table is not None:
        tables["type_table"] = type_table
    if type_ids is not None:
        tables["type_ids"] = type_ids
    device = check_cuda("embed_ln", ids=ids, **tables)
    if ids.dim() != 2:
        raise ValueError(f"embed_ln: ids must be [B, L], got {tuple(ids.shape)}")
    B, L = ids.shape
    h = word.shape[-1]
    if dtype != torch.bfloat16:
        raise ValueError(f"embed_ln: the kernel writes bf16, asked for {dtype}")
    if ids.dtype not in _INDEX_KINDS or ids.dtype == torch.uint8:
        raise ValueError(f"embed_ln: ids must be int16, int32 or int64, got {ids.dtype}")
    if type_ids is not None and (type_ids.shape != ids.shape or type_ids.dtype not in _INDEX_KINDS):
        raise ValueError(f"embed_ln: type_ids {tuple(type_ids.shape)} {type_ids.dtype}")
    for name, t in (("word", word), ("position", position), ("type_table", type_table)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != h or t.data_ptr() % 16:
            raise ValueError(f"embed_ln: {name} must be a 16-byte aligned f32 [n, {h}] table")
    if position.shape[0] < L:
        raise ValueError(f"embed_ln: sequence length {L} > {position.shape[0]} positions")
    check_norm_params("embed_ln", h, scale, bias)
    out = torch.empty((B, L, h), dtype=dtype, device=device)
    if B * L == 0:
        return out
    launch(
        "embed_ln", _build.library("embed_ln").pw_embed_ln, device,
        ids.data_ptr(), _INDEX_KINDS[ids.dtype],
        None if type_ids is None else type_ids.data_ptr(),
        0 if type_ids is None else _INDEX_KINDS[type_ids.dtype],
        word.data_ptr(), word.shape[0], position.data_ptr(),
        None if type_table is None else type_table.data_ptr(),
        0 if type_table is None else type_table.shape[0],
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, L, h, float(eps),
    )
    embed_ln.launches += 1
    return out


#: launches of the CUDA kernel in this process
embed_ln.launches = 0
