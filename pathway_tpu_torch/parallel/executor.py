"""Batched encoder executor: :class:`TorchEncoder`, the port's counterpart
of ``pathway_tpu.parallel.JittedEncoder``.

A whole epoch's rows are tokenized into bucketed batches (power-of-two
rows, padded rows given one valid token) and pushed through one
:class:`~pathway_tpu_torch.models.TextEncoderModel` (or, with
``cross=True``, :class:`~pathway_tpu_torch.models.CrossEncoderModel`)
forward per chunk on the card.  Token ids upload as int16 (mask and
type ids as uint8) when the vocabulary fits, a third of the int32 bytes.  Up to
``pipeline_depth`` chunks are enqueued before the oldest result is read
back, so tokenizing one chunk overlaps the device work of the previous
ones; :meth:`TorchEncoder.encode_into` keeps the embeddings on the
device and upserts them straight into a
:class:`~pathway_tpu_torch.parallel.ShardedKnnIndex`, and
:meth:`TorchEncoder.score_pairs` scores (query, doc) pairs with the
cross-encoder.

``checkpoint_dir=`` loads a local HuggingFace checkpoint directory
(config, weights, WordPiece vocabulary) as the JAX executor does
(``pathway_tpu/parallel/executor.py:69-100``).  ``mesh=`` runs data
parallel over the mesh's ``data_axis`` (``:115-197``): one replica of
the model per distinct device along it, each batch padded to a multiple
of the data-parallel degree and cut into that many equal parts, each
part's forward enqueued on its device before any result is read, and the
parts' outputs gathered in order on the mesh's first device.  The mesh is
driven from this one process (see :mod:`~pathway_tpu_torch.parallel.mesh`);
tensor and sequence parallelism raise (ROADMAP A9b).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import finish_readback, resolve_device, start_readback, upload
from pathway_tpu_torch.internals import device_counters as _devctr
from pathway_tpu_torch.models import convert as _convert
from pathway_tpu_torch.models.encoder import CrossEncoderModel, EncoderConfig, TextEncoderModel
from pathway_tpu_torch.models.tokenizer import Tokenizer, get_tokenizer
from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer
from pathway_tpu_torch.ops.bucketing import bucket_size
from pathway_tpu_torch.parallel.mesh import Mesh, data_devices

__all__ = ["TorchEncoder"]


class TorchEncoder:
    """Holds the encoder on ``device`` and runs it over bucketed batches.

    cross=False: ``encode(texts) -> [n, hidden] float32`` embeddings.
    cross=True:  ``score_pairs(queries, docs) -> [n] float32`` logits.
    ``params`` takes a flax parameter tree of the JAX package's
    ``TextEncoderModel`` or ``CrossEncoderModel`` (see
    :func:`~pathway_tpu_torch.models.state_dict_from_flax`);
    ``checkpoint_dir`` a local HF checkpoint directory, whose
    ``config.json`` gives the config (an explicit ``config`` overrides only
    its pooling and activation type); without either the weights are a
    seeded random init.  With ``mesh`` the devices come from the mesh and
    ``device`` is not read; a mesh axis besides ``data_axis`` larger than
    1, or a ``sequence_axis``, raises ``NotImplementedError`` (ROADMAP A9b).
    """

    def __init__(
        self,
        config: EncoderConfig | None,
        *,
        cross: bool = False,
        tokenizer: Tokenizer | None = None,
        model_name: str | None = None,
        mesh: Mesh | None = None,
        data_axis: str = "data",
        max_batch: int = 1024,
        max_len: int | None = None,
        seed: int = 0,
        params: Any = None,
        checkpoint_dir: str | None = None,
        pipeline_depth: int = 2,
        sequence_axis: str | None = None,
        device: str | torch.device = "cuda",
    ):
        if sequence_axis is not None:
            raise NotImplementedError(
                "sequence parallelism (ring attention) comes with ROADMAP A9b"
            )
        # the data-parallel devices, one part of every batch each (repeats allowed)
        self._dp_devices = (
            [resolve_device(device)] if mesh is None else data_devices(mesh, data_axis, "TorchEncoder")
        )
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = self._dp_devices[0]
        self._dp = len(self._dp_devices)
        state = None
        if checkpoint_dir is not None:
            if params is not None:
                raise ValueError(
                    "pass either params= or checkpoint_dir=, not both: explicit params "
                    "would be silently replaced"
                )
            user_cfg = config
            config = _convert.config_from_hf(
                checkpoint_dir,
                pool=user_cfg.pool if user_cfg is not None else None,
                num_labels=1 if cross else 0,
            )
            config = dataclasses.replace(config, normalize=not cross)
            if user_cfg is not None:
                config = dataclasses.replace(config, dtype=user_cfg.dtype)
            state = _convert.convert_bert_checkpoint(_convert.load_state_dict(checkpoint_dir), config)
            vocab = os.path.join(checkpoint_dir, "vocab.txt")
            if tokenizer is None and os.path.exists(vocab):
                tokenizer = WordPieceTokenizer(vocab)
        elif config is None:
            raise ValueError("config is required without checkpoint_dir")
        elif params is not None:
            state = _convert.state_dict_from_flax(params, config, cross=cross)
        self.config = config
        self.cross = cross
        self.max_batch = max_batch
        self.max_len = max_len or config.max_len
        self.pipeline_depth = max(1, pipeline_depth)
        self.tokenizer = tokenizer or get_tokenizer(model_name, config.vocab_size)
        model_cls = CrossEncoderModel if cross else TextEncoderModel
        self.model = model_cls(config, device=self.device, seed=seed)
        if state is not None:
            self.model.load_state_dict(state)
        self.model.eval()
        # one replica per distinct device, its weights copied from the first
        self._replicas = {self.device: self.model}
        for dev in self._dp_devices:
            if dev not in self._replicas:
                self._replicas[dev] = copy.deepcopy(self.model).to(dev)
        # ids upload as int16 when the vocab permits (mask/type as uint8)
        self._narrow_ids = config.vocab_size < 2**15

    # ------------------------------------------------------------------
    def _pad_batch(self, ids: np.ndarray, mask: np.ndarray, tps: np.ndarray):
        """Round the batch up to a power-of-two bucket of rows, then to a
        multiple of the data-parallel degree."""
        n = ids.shape[0]
        b = bucket_size(n, min_bucket=max(8, self._dp))
        b = -(-b // self._dp) * self._dp
        if b > n:
            pad = ((0, b - n), (0, 0))
            ids = np.pad(ids, pad)
            mask = np.pad(mask, pad)
            tps = np.pad(tps, pad)
        # padded rows must still be valid encoder input: one non-masked token
        mask[n:, 0] = 1
        return ids, mask, tps, n

    def _upload_parts(self, ids: np.ndarray, mask: np.ndarray, tps: np.ndarray):
        """Pad one tokenized chunk, narrow its types and start its upload,
        one equal part of its rows to each data-parallel device; returns
        ([[ids, mask, type_ids] per part], n real rows)."""
        ids, mask, tps, n = self._pad_batch(ids, mask, tps)
        if self._narrow_ids:
            ids = ids.astype(np.int16, copy=False)
            mask = mask.astype(np.uint8, copy=False)
            tps = tps.astype(np.uint8, copy=False)
        _devctr.record_h2d(ids.nbytes + mask.nbytes + tps.nbytes)
        arrays = (ids, mask, tps)
        m = ids.shape[0] // self._dp
        return [
            [upload(a[i * m : (i + 1) * m], dev) for a in arrays]
            for i, dev in enumerate(self._dp_devices)
        ], n

    def _dispatch(self, ids: np.ndarray, mask: np.ndarray, tps: np.ndarray):
        """Upload one padded chunk and enqueue its forward, each part on its
        device; returns (device output on the first device, [b, hidden] or
        [b] f32, n real rows) without waiting."""
        parts, n = self._upload_parts(ids, mask, tps)
        with torch.inference_mode():
            outs = [self._replicas[dev](*args) for dev, args in zip(self._dp_devices, parts)]
            out = outs[0] if len(outs) == 1 else torch.cat([o.to(self.device) for o in outs])
        return out, n

    def _chunks(self, texts: Sequence[str], pair: Sequence[str] | None = None):
        """Chunks of ``max_batch`` rows, each tokenized (with its ``pair``
        texts second, when given)."""
        for i in range(0, len(texts), self.max_batch):
            sl = slice(i, i + self.max_batch)
            yield self.tokenizer.encode_batch(
                texts[sl], pair=None if pair is None else pair[sl], max_len=self.max_len
            )

    def _run_pipelined(self, texts: list, pair: list | None) -> np.ndarray:
        """Dispatch up to ``pipeline_depth`` chunks before reading back the
        oldest, so tokenizing one chunk overlaps the device work and the
        readback of the ones before it; the real rows, concatenated."""
        outs: list[np.ndarray] = []
        inflight: deque = deque()

        def collect() -> None:
            handle, n = inflight.popleft()
            (host,) = finish_readback(handle)
            _devctr.record_d2h(host.nbytes)
            outs.append(host[:n])

        for batch in self._chunks(texts, pair):
            out, n = self._dispatch(*batch)
            inflight.append((start_readback(out), n))
            if len(inflight) >= self.pipeline_depth:
                collect()
        while inflight:
            collect()
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Embed a list of texts -> [n, hidden] float32."""
        if self.cross:
            raise TypeError("cross-encoder executor: use score_pairs()")
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.config.hidden), np.float32)
        return self._run_pipelined(texts, None)

    def encode_into(self, index: Any, keys: Sequence[Any], texts: Sequence[str]) -> int:
        """Embed ``texts`` and upsert the embeddings into ``index``
        (``ShardedKnnIndex.add_batch_device``) on the device: token ids go
        up, no embedding comes down.  Returns the number of rows indexed."""
        if self.cross:
            raise TypeError("cross-encoder executor: use score_pairs()")
        texts = list(texts)
        keys = list(keys)
        if len(keys) != len(texts):
            raise ValueError("keys and texts must align")
        pos = 0
        for batch in self._chunks(texts):
            out, n = self._dispatch(*batch)
            # the upsert is enqueued behind the forward on the same stream
            index.add_batch_device(keys[pos : pos + n], out, n_valid=n)
            pos += n
        return pos

    def score_pairs(self, queries: Sequence[str], docs: Sequence[str]) -> np.ndarray:
        """Cross-encoder scores for aligned (query, doc) pairs -> [n]
        float32; each query is the first text of its pair, as the JAX
        executor tokenizes them."""
        if not self.cross:
            raise TypeError("bi-encoder executor: use encode()")
        if len(queries) != len(docs):
            raise ValueError("queries and docs must align")
        if not len(queries):
            return np.zeros((0,), np.float32)
        return self._run_pipelined(list(queries), list(docs))
