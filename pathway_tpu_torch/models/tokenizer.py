"""Tokenizers feeding the port's encoders.

The port's own copy of ``pathway_tpu/models/tokenizer.py`` (no jax in
it, but the port imports nothing of the JAX package).
:class:`HashTokenizer` is a deterministic hashing WordPiece stand-in:
lowercase, split on non-alphanumerics, id = blake2b hash of the token
folded into the vocab.  Its ids are identical to the JAX package's, so
both packages feed their encoders the same batches.

The HuggingFace and WordPiece tokenizers wait until a checkpoint with a
``vocab.txt`` is in the repository; :func:`get_tokenizer` returns the
hash tokenizer until then.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

from pathway_tpu_torch.ops.bucketing import bucket_size

__all__ = ["Tokenizer", "HashTokenizer", "get_tokenizer"]

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


def get_tokenizer(model_name: str | None = None, vocab_size: int = 30522) -> Tokenizer:
    """The deterministic hash tokenizer (``model_name`` is accepted for the
    JAX package's signature; no local checkpoint tokenizer is ported yet)."""
    return HashTokenizer(vocab_size)
