"""WordPiece tokenizer (BERT family) loaded from a checkpoint's ``vocab.txt``
(counterpart of ``pathway_tpu/models/wordpiece.py``).

The BERT tokenization pipeline in pure Python: basic tokenization
(clean, CJK spacing, optional lowercasing + accent stripping,
punctuation splitting), then greedy longest-match-first WordPiece.  It
gives the ids of ``transformers.BertTokenizer`` on the same vocabulary,
and the ids of the JAX package's tokenizer, whose C++ fast path gives
the same ids as its pure path; the port's fast path comes with the
native module (ROADMAP A12).

Nothing is downloaded: the vocabulary file must exist locally.
"""

from __future__ import annotations

import unicodedata
from typing import Sequence

import numpy as np

from pathway_tpu_torch.models.tokenizer import Tokenizer
from pathway_tpu_torch.ops.bucketing import bucket_size

__all__ = ["WordPieceTokenizer", "load_vocab"]


def load_vocab(vocab_file: str) -> dict[str, int]:
    """Token -> id, the id being the token's line number."""
    vocab: dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even where unicode does not
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer(Tokenizer):
    """BERT tokenization: basic tokenizer + WordPiece over a vocab file."""

    def __init__(
        self,
        vocab_file: str,
        *,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = load_vocab(vocab_file)
        self.do_lower_case = do_lower_case
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.max_input_chars_per_word = max_input_chars_per_word
        self.vocab_size = len(self.vocab)

    # -- basic tokenization -------------------------------------------
    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        return "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text) if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> list[str]:
        out: list[list[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._space_cjk(self._clean(text))
        tokens: list[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return tokens

    # -- wordpiece ----------------------------------------------------
    def wordpiece(self, token: str) -> list[int]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: list[int] = []
        start, n = 0, len(token)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = token[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in self.basic_tokenize(text):
            ids.extend(self.wordpiece(tok))
        return ids

    def tokenize_ids_batch(self, texts: Sequence[str]) -> list[list[int]]:
        return [self.tokenize_ids(t) for t in texts]

    # -- Tokenizer interface ------------------------------------------
    def count_tokens(self, text: str) -> int:
        return len(self.tokenize_ids(text))

    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        max_len: int = 512,
        pair: Sequence[str] | None = None,
        bucket_len: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        firsts = self.tokenize_ids_batch(texts)
        seconds = self.tokenize_ids_batch(pair) if pair is not None else None
        rows: list[list[int]] = []
        types: list[list[int]] = []
        for i in range(len(texts)):
            first = firsts[i]
            if seconds is not None:
                second = seconds[i]
                # HF "longest_first" pair truncation: trim the longer side
                budget = max(0, max_len - 3)
                while len(first) + len(second) > budget and (first or second):
                    if len(first) >= len(second):
                        first = first[:-1]
                    else:
                        second = second[:-1]
                ids = [self.cls_id] + first + [self.sep_id] + second + [self.sep_id]
                tps = [0] * (len(first) + 2) + [1] * (len(second) + 1)
            else:
                ids = [self.cls_id] + first[: max(0, max_len - 2)] + [self.sep_id]
                tps = [0] * len(ids)
            rows.append(ids)
            types.append(tps)
        longest = max((len(r) for r in rows), default=1)
        width = bucket_size(longest, min_bucket=16, max_bucket=max_len) if bucket_len else max_len
        width = max(width, longest)
        b = len(rows)
        ids_arr = np.full((b, width), self.pad_id, dtype=np.int32)
        mask = np.zeros((b, width), dtype=np.int32)
        type_arr = np.zeros((b, width), dtype=np.int32)
        for i, (r, t) in enumerate(zip(rows, types)):
            ids_arr[i, : len(r)] = r
            mask[i, : len(r)] = 1
            type_arr[i, : len(t)] = t
        return ids_arr, mask, type_arr
