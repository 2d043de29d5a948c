"""Tokenizers feeding the port's encoders.

The port's own copy of ``pathway_tpu/models/tokenizer.py`` (no jax in
it, but the port imports nothing of the JAX package).
:class:`HashTokenizer` is a deterministic hashing WordPiece stand-in:
lowercase, split on non-alphanumerics, id = blake2b hash of the token
folded into the vocab.  Its ids are identical to the JAX package's, so
both packages feed their encoders the same batches.

:class:`HFTokenizer` wraps a locally stored HuggingFace tokenizer (a
cache entry or a directory, never a download; ``transformers`` is
imported only when one is asked for), and :func:`get_tokenizer` picks it
for a model name that resolves locally, else the hash tokenizer, as the
JAX package's does.  A checkpoint's ``vocab.txt`` is read by
:class:`~pathway_tpu_torch.models.wordpiece.WordPieceTokenizer`.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Sequence

import numpy as np

from pathway_tpu_torch.ops.bucketing import bucket_size

__all__ = ["Tokenizer", "HashTokenizer", "HFTokenizer", "get_tokenizer"]

_WORD_RE = re.compile(r"[a-z0-9]+", re.UNICODE)

PAD_ID = 0
CLS_ID = 101
SEP_ID = 102
_RESERVED = 1000  # ids below this are reserved for specials


class Tokenizer:
    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        max_len: int = 512,
        pair: Sequence[str] | None = None,
        bucket_len: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (ids, mask, type_ids), each int32 [B, L]."""
        raise NotImplementedError

    def count_tokens(self, text: str) -> int:
        raise NotImplementedError


class HashTokenizer(Tokenizer):
    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def _token_id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=8).digest(), "little")
        return _RESERVED + h % (self.vocab_size - _RESERVED)

    def _tokens(self, text: str) -> list[int]:
        return [self._token_id(t) for t in _WORD_RE.findall(text.lower())]

    def count_tokens(self, text: str) -> int:
        return len(_WORD_RE.findall(text.lower()))

    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        max_len: int = 512,
        pair: Sequence[str] | None = None,
        bucket_len: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows: list[list[int]] = []
        types: list[list[int]] = []
        for i, text in enumerate(texts):
            ids = [CLS_ID] + self._tokens(text)[: max_len - 2] + [SEP_ID]
            tps = [0] * len(ids)
            if pair is not None:
                second = self._tokens(pair[i])[: max_len - len(ids) - 1] + [SEP_ID]
                ids += second
                tps += [1] * len(second)
            rows.append(ids[:max_len])
            types.append(tps[:max_len])
        longest = max((len(r) for r in rows), default=1)
        width = bucket_size(longest, min_bucket=16, max_bucket=max_len) if bucket_len else max_len
        width = max(width, longest)
        b = len(rows)
        ids_arr = np.full((b, width), PAD_ID, dtype=np.int32)
        mask = np.zeros((b, width), dtype=np.int32)
        type_arr = np.zeros((b, width), dtype=np.int32)
        for i, (r, t) in enumerate(zip(rows, types)):
            ids_arr[i, : len(r)] = r
            mask[i, : len(r)] = 1
            type_arr[i, : len(t)] = t
        return ids_arr, mask, type_arr


class HFTokenizer(Tokenizer):
    """Locally stored HuggingFace tokenizer (no downloads attempted)."""

    def __init__(self, name: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name, local_files_only=True)

    def count_tokens(self, text: str) -> int:
        return len(self._tok.encode(text, add_special_tokens=False))

    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        max_len: int = 512,
        pair: Sequence[str] | None = None,
        bucket_len: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        enc = self._tok(
            list(texts),
            text_pair=list(pair) if pair is not None else None,
            truncation=True,
            max_length=max_len,
            padding=True,
            return_tensors="np",
        )
        ids = enc["input_ids"].astype(np.int32)
        mask = enc["attention_mask"].astype(np.int32)
        if bucket_len:
            width = min(max(bucket_size(ids.shape[1], min_bucket=16), ids.shape[1]), max_len)
            if width > ids.shape[1]:
                pad = width - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, pad)))
                mask = np.pad(mask, ((0, 0), (0, pad)))
        tps = enc.get("token_type_ids")
        tps = tps.astype(np.int32) if tps is not None and tps.shape == ids.shape else np.zeros_like(ids)
        return ids, mask, tps


def _may_resolve_locally(name: str) -> bool:
    """False only where ``AutoTokenizer.from_pretrained(name,
    local_files_only=True)`` cannot succeed: ``name`` is no directory and
    has no entry in the HuggingFace hub cache.  Importing ``transformers``
    takes 8-25 s in a fresh process, and every restarted worker that builds
    an embedder of a preset name (``"bge-base"``) would pay it only to fall
    back to the hash tokenizer."""
    if os.path.isdir(name):
        return True
    try:
        from huggingface_hub import constants
    except ImportError:
        return True  # cannot tell: let transformers decide
    caches = {constants.HF_HUB_CACHE, os.environ.get("TRANSFORMERS_CACHE") or constants.HF_HUB_CACHE}
    entry = "models--" + name.replace("/", "--")
    return any(os.path.isdir(os.path.join(cache, entry)) for cache in caches)


def get_tokenizer(model_name: str | None = None, vocab_size: int = 30522) -> Tokenizer:
    """The HuggingFace tokenizer of ``model_name`` where it resolves
    locally (a cache entry or a directory), else the deterministic hash
    tokenizer, as the JAX package chooses."""
    if model_name and _may_resolve_locally(model_name):
        try:
            return HFTokenizer(model_name)
        except Exception:
            pass
    return HashTokenizer(vocab_size)
