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
(``pathway_tpu/parallel/executor.py:69-100``).  ``mesh=`` spreads the
model over the mesh as the JAX executor shards it (``:102-197``), by
:func:`~pathway_tpu_torch.parallel.mesh.encoder_grids`:

- data parallel over ``data_axis``: one replica of the model per
  distinct device group along it, each batch padded to a multiple of the
  data-parallel degree and cut into that many equal parts, each part's
  forward enqueued before any result is read, and the parts' outputs
  gathered in order on the mesh's first device;
- tensor parallel over ``model_axis``: each replica is a group of the
  devices along it, each holding its shard of the heads and MLP width,
  cut once from the full weights by
  :func:`~pathway_tpu_torch.models.encoder_param_specs`; the full
  weights stay in host memory;
- sequence parallel over ``sequence_axis`` (the long-document path):
  every batch is padded to the full ``max_len`` and cut along the
  sequence over the axis's devices, and attention is ring attention
  (K14); the batch is then not split.

The mesh is driven from this one process (see
:mod:`~pathway_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

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
from pathway_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, encoder_grids

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
    ``device`` is not read; ``sequence_axis`` needs a mesh with that axis
    and a ``max_len`` that divides by its size; a mesh axis larger than 1
    besides ``data_axis``, ``model_axis`` and ``sequence_axis`` raises
    ``NotImplementedError``.
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
        model_axis: str = MODEL_AXIS,
        max_batch: int = 1024,
        max_len: int | None = None,
        seed: int = 0,
        params: Any = None,
        checkpoint_dir: str | None = None,
        pipeline_depth: int = 2,
        sequence_axis: str | None = None,
        device: str | torch.device = "cuda",
    ):
        if sequence_axis is not None and (mesh is None or sequence_axis not in mesh.shape):
            raise ValueError("sequence_axis requires a mesh containing that axis")
        # the device grid of each data-parallel replica (repeats allowed)
        self._grids = (
            [[[resolve_device(device)]]] if mesh is None
            else encoder_grids(mesh, data_axis, sequence_axis, model_axis)
        )
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.sequence_axis = sequence_axis
        self.device = self._grids[0][0][0]
        self._dp = len(self._grids)
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
        if sequence_axis is not None:
            config = dataclasses.replace(config, seq_mesh=mesh, seq_axis=sequence_axis)
        self.config = config
        self.cross = cross
        self.max_batch = max_batch
        self.max_len = max_len or config.max_len
        if sequence_axis is not None and self.max_len % mesh.shape[sequence_axis]:
            raise ValueError(
                f"max_len {self.max_len} must divide by the {sequence_axis!r} axis size "
                f"{mesh.shape[sequence_axis]}"
            )
        self.pipeline_depth = max(1, pipeline_depth)
        self.tokenizer = tokenizer or get_tokenizer(model_name, config.vocab_size)
        model_cls = CrossEncoderModel if cross else TextEncoderModel
        # cut into model shards, the full weights stay in host memory: each
        # device holds only its shards
        home = torch.device("cpu") if len(self._grids[0][0]) > 1 else None
        # one replica per distinct device grid, its weights those of the first
        replicas: dict = {}
        for grid in self._grids:
            key = tuple(map(tuple, grid))
            if key not in replicas:
                first = next(iter(replicas.values()), None)
                model = model_cls(config, device=home or grid[0][0], seed=seed if first is None else None,
                                  grid=grid)
                if first is not None or state is not None:
                    model.load_state_dict(state if first is None else first.state_dict())
                replicas[key] = model.eval()
        self._replicas = [replicas[tuple(map(tuple, grid))] for grid in self._grids]
        self.model = self._replicas[0]
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
        """Pad one tokenized chunk (to the full ``max_len`` when the
        sequence is split), narrow its types and start its upload, one
        equal part of its rows to each data-parallel replica's first
        device; returns ([[ids, mask, type_ids] per part], n real rows)."""
        ids, mask, tps, n = self._pad_batch(ids, mask, tps)
        if self.sequence_axis is not None and ids.shape[1] < self.max_len:
            pad = ((0, 0), (0, self.max_len - ids.shape[1]))
            ids, mask, tps = (np.pad(a, pad) for a in (ids, mask, tps))
        if self._narrow_ids:
            ids = ids.astype(np.int16, copy=False)
            mask = mask.astype(np.uint8, copy=False)
            tps = tps.astype(np.uint8, copy=False)
        _devctr.record_h2d(ids.nbytes + mask.nbytes + tps.nbytes)
        arrays = (ids, mask, tps)
        m = ids.shape[0] // self._dp
        return [
            [upload(a[i * m : (i + 1) * m], grid[0][0]) for a in arrays]
            for i, grid in enumerate(self._grids)
        ], n

    def _dispatch(self, ids: np.ndarray, mask: np.ndarray, tps: np.ndarray, pooled: bool = True):
        """Upload one padded chunk and enqueue its forward, each part on its
        device; returns (device output on the first device, [b, hidden] or
        [b] f32, n real rows) without waiting.  ``pooled=False`` (one
        replica) stops before the tail: ((last hidden state, uint8 mask) on
        the model's first device, n real rows)."""
        parts, n = self._upload_parts(ids, mask, tps)
        with torch.inference_mode():
            if not pooled:
                (args,) = parts
                return self.model.pool_inputs(*args), n
            outs = [model(*args) for model, args in zip(self._replicas, parts)]
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
        """Embed ``texts`` and upsert the embeddings into ``index`` on the
        device: token ids go up, no embedding comes down.  With one replica
        each chunk's last hidden state goes to
        ``ShardedKnnIndex.add_pooled_device``, which pools it (the ingest
        tail, one launch, where the index has one shard on the model's
        device); with several, K7 pools each part and
        ``ShardedKnnIndex.add_batch_device`` scatters the rows (K2).
        Returns the number of rows indexed."""
        if self.cross:
            raise TypeError("cross-encoder executor: use score_pairs()")
        texts = list(texts)
        keys = list(keys)
        if len(keys) != len(texts):
            raise ValueError("keys and texts must align")
        pos = 0
        for batch in self._chunks(texts):
            # the upsert is enqueued behind the forward on the same stream
            if self._dp == 1:
                (hidden, mask), n = self._dispatch(*batch, pooled=False)
                index.add_pooled_device(keys[pos : pos + n], hidden, mask, self.config.pool,
                                        self.config.normalize, n_valid=n)
            else:
                out, n = self._dispatch(*batch)
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
