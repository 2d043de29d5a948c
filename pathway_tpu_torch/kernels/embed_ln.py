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
launches the kernel (bf16 or f32 output; ids as int16, int32 or int64 and
type ids as uint8 or an int type, read as uploaded; f32 tables) and
raises on anything else (:func:`check_embed_ln` says what it takes); for
CPU tensors it runs :func:`embed_ln_plain`.  ``type_ids=None`` means
zeros; ``type_table=None`` means the config has no type vocabulary.
Token ``l`` reads ``position[l]``: a block of a longer sequence that
starts at position ``s`` passes the view ``position[s:]``, which keeps
the kernel's 16-byte alignment (a row is ``H * 4`` bytes, ``H`` a
multiple of 8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathway_tpu_torch.kernels import _build
from pathway_tpu_torch.kernels._launch import check_cuda, launch
from pathway_tpu_torch.kernels.add_layer_norm import (
    DTYPES,
    EMBEDDING,
    bwd_grid,
    check_norm_params,
    layer_norm_bwd_plain,
    layer_norm_plain,
)

__all__ = [
    "embed_ln", "embed_ln_plain", "check_embed_ln", "embed_ln_bwd", "embed_ln_bwd_plain", "EmbedLnFunction",
    "bwd_plan", "ITEM_ROWS",
]

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


def check_embed_ln(
    ids: torch.Tensor, type_ids: torch.Tensor | None, word: torch.Tensor,
    position: torch.Tensor, type_table: torch.Tensor | None, scale: torch.Tensor,
    bias: torch.Tensor, dtype: torch.dtype,
) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments; reads
    shapes, types and alignment only, on any device."""
    if ids.dim() != 2:
        raise ValueError(f"embed_ln: ids must be [B, L], got {tuple(ids.shape)}")
    L = ids.shape[1]
    h = word.shape[-1]
    if dtype not in DTYPES:
        raise ValueError(f"embed_ln: the kernel writes bf16 or f32, asked for {dtype}")
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
    check_embed_ln(ids, type_ids, word, position, type_table, scale, bias, dtype)
    B, L = ids.shape
    h = word.shape[-1]
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
        int(dtype == torch.float32),
    )
    embed_ln.launches += 1
    return out


#: launches of the CUDA kernel in this process
embed_ln.launches = 0


# ---------------------------------------------------------------------------
# K17's embedding form (csrc/layer_norm_bwd.cu), and K6's autograd Function


def _rows(table: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each id's table row (wrapped as flax wraps it) and whether it is in
    range (an id out of range gathered a NaN row, and gets no gradient)."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    return ids.clamp(0, n - 1), ok


def embed_ln_bwd_plain(
    dy: torch.Tensor, ids: torch.Tensor, type_ids: torch.Tensor | None, word: torch.Tensor,
    position: torch.Tensor, type_table: torch.Tensor | None, scale: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """``(d_word, d_position, d_type, dgamma, dbeta)`` of K6's f32 forward:
    LayerNorm's backward on the sums, each row's ds added into the rows it
    gathered."""
    B, L = ids.shape
    h = word.shape[1]
    wi, ok = _rows(word, ids.long())
    s = word[wi] + position[:L][None]
    ti = None
    if type_table is not None:
        ti, tok = _rows(type_table, torch.zeros_like(wi) if type_ids is None else type_ids.long())
        ok = ok & tok
        s = s + type_table[ti]
    s = torch.where(ok[..., None], s, torch.full_like(s, float("nan")))
    ds, d_gamma, d_beta = layer_norm_bwd_plain(dy.reshape(B, L, h), s, scale, eps)
    keep = ok.reshape(-1)
    rows = ds.reshape(-1, h)[keep]
    d_word = torch.zeros_like(word).index_add_(0, wi.reshape(-1)[keep], rows)
    pos = torch.arange(L, device=ids.device).expand(B, L).reshape(-1)[keep]
    d_position = torch.zeros_like(position).index_add_(0, pos, rows)
    d_type = None if ti is None else torch.zeros_like(type_table).index_add_(0, ti.reshape(-1)[keep], rows)
    return d_word, d_position, d_type, d_gamma, d_beta


#: rows of one position that an item of the backward sorts (one a thread
#: of its block, ``kItemRows`` in csrc/layer_norm_bwd.cu)
ITEM_ROWS = 256


def bwd_plan(batch: int, seq_len: int, grid: int) -> tuple[int, int]:
    """K17's embedding form walks the rows position by position in items:
    ``(chunks, rows)``, item ``c * seq_len + l`` holding rows ``b`` in
    ``[c * rows, min(batch, (c + 1) * rows))`` at position ``l``.  A position
    is split into ``chunks`` items when the grid has blocks to spare (about
    ``grid`` items in all) or its rows exceed ITEM_ROWS; no item is empty."""
    chunks = min(batch, max(1, grid // seq_len, -(-batch // ITEM_ROWS)))
    rows = -(-batch // chunks)
    return -(-batch // rows), rows


def embed_ln_bwd(
    dy: torch.Tensor, ids: torch.Tensor, type_ids: torch.Tensor | None, word: torch.Tensor,
    position: torch.Tensor, type_table: torch.Tensor | None, scale: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """K6's backward, the sums gathered again from the ids and tables; the
    kernel on a card (one cooperative launch: the rows position by
    position, each position's rows sorted by id so that a repeated id adds
    into its table row once per block, then dgamma and dbeta summed in
    order), the plain version for CPU tensors."""
    if dy.device.type == "cpu":
        return embed_ln_bwd_plain(dy, ids, type_ids, word, position, type_table, scale, eps)
    check_embed_ln(ids, type_ids, word, position, type_table, scale, scale, torch.float32)
    tables = {"word": word, "position": position, "scale": scale, "dy": dy}
    if type_table is not None:
        tables["type_table"] = type_table
    if type_ids is not None:
        tables["type_ids"] = type_ids
    device = check_cuda("embed_ln_bwd", ids=ids, **tables)
    B, L = ids.shape
    h = word.shape[1]
    if dy.dtype != torch.float32 or dy.numel() != B * L * h:
        raise ValueError(f"embed_ln_bwd: dy must be f32 [{B}, {L}, {h}]")
    if B * L == 0:
        return (torch.zeros_like(word), torch.zeros_like(position),
                None if type_table is None else torch.zeros_like(type_table),
                torch.zeros_like(scale), torch.zeros_like(scale))
    # the kernel writes every row of the gradient tables
    d_word = torch.empty_like(word)
    d_position = torch.empty_like(position)
    d_type = None if type_table is None else torch.empty_like(type_table)
    counts = torch.zeros((word.shape[0],), dtype=torch.int32, device=device)
    d_gamma = torch.empty((h,), dtype=torch.float32, device=device)
    d_beta = torch.empty((h,), dtype=torch.float32, device=device)
    grid = bwd_grid(EMBEDDING, h, device)
    chunks, rows = bwd_plan(B, L, grid)
    blocks = min(grid, chunks * L)
    partial = torch.empty((2, blocks, h), dtype=torch.float32, device=device)
    pos_partial = torch.empty((chunks * L, h), dtype=torch.float32, device=device) if chunks > 1 else None
    launch(
        "embed_ln_bwd", _build.library("layer_norm_bwd").pw_embed_ln_bwd, device,
        ids.data_ptr(), _INDEX_KINDS[ids.dtype],
        None if type_ids is None else type_ids.data_ptr(),
        0 if type_ids is None else _INDEX_KINDS[type_ids.dtype],
        word.data_ptr(), word.shape[0], position.data_ptr(), position.shape[0],
        None if type_table is None else type_table.data_ptr(),
        0 if type_table is None else type_table.shape[0], B, L, chunks, rows,
        d_word.data_ptr(), d_position.data_ptr(), None if d_type is None else d_type.data_ptr(),
        None if pos_partial is None else pos_partial.data_ptr(), counts.data_ptr(),
        dy.data_ptr(), scale.data_ptr(), partial.data_ptr(), d_gamma.data_ptr(), d_beta.data_ptr(),
        h, float(eps), blocks,
    )
    embed_ln_bwd.launches += 1
    return d_word, d_position, d_type, d_gamma, d_beta


#: launches of the CUDA kernel in this process (one a call)
embed_ln_bwd.launches = 0


class EmbedLnFunction(torch.autograd.Function):
    """K6 forward, K17 backward into the word, position and type tables
    and the LayerNorm's scale and bias.  The forward keeps the ids and the
    tables (the backward gathers the sums again).  Training runs in f32:
    a bf16 call runs K6 and its backward raises."""

    @staticmethod
    def forward(ctx, ids, type_ids, word, position, type_table, scale, bias, eps, dtype):
        ctx.eps = eps
        ctx.trained = dtype == torch.float32
        if ctx.trained:
            ctx.save_for_backward(ids, type_ids, word, position, type_table, scale)
        return embed_ln(ids, type_ids, word, position, type_table, scale, bias, eps, dtype)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.trained:
            raise NotImplementedError("embed_ln: the backward kernels take f32; bf16 is not trained")
        ids, type_ids, word, position, type_table, scale = ctx.saved_tensors
        d_word, d_position, d_type, d_gamma, d_beta = embed_ln_bwd(
            dout.contiguous(), ids, type_ids, word, position, type_table, scale, ctx.eps)
        return None, None, d_word, d_position, d_type, d_gamma, d_beta, None, None
