"""BERT-family text encoders and cross-encoders in PyTorch (counterpart
of ``pathway_tpu/models/encoder.py``).

Same configuration, presets, parameter names and numerics as the flax
modules, so the same weights (``models/convert.py``) give the same
outputs:

- f32 parameters, activations in ``cfg.dtype`` (bf16 for the presets);
  every dense layer casts its weight to the activation type per call,
  rounds the product to it and adds its bias after the product, as flax
  ``Dense(dtype=...)`` does;
- the word + position (+ type) embedding sum in the activation type, in
  flax's order;
- post-LN blocks, LayerNorm statistics in f32 with ``ln_eps`` (1e-12);
- tanh GELU unless ``gelu_approx=False``;
- pooled embedding L2-normalized in f32 with eps 1e-12.

Everything but the encoder blocks' dense products runs through the
port's kernels: K6 ``embed_ln`` (embeddings), K1 ``attention``, K4
``bias_act`` (every dense layer's bias and the GELU), K5
``add_layer_norm`` (both residual LayerNorms of a block), K7
``pool_normalize`` (the sentence encoder's tail) and ``cross_head`` (the
cross-encoder's whole head, its two products included: B8).  The blocks'
products are ``F.linear`` without bias (cuBLAS), as the JAX package
leaves them to XLA.

Training (``pathway_tpu_torch.train``): where grad is enabled and an
input or parameter requires it, each kernel call goes through its
autograd Function, whose backward is a kernel too (K15 for attention,
K16 for K4, K17 for K5 and K6, K18's pool backward for K7); in f32 a
weight's ``.to(x.dtype)`` is the parameter itself, so ``F.linear``'s
autograd reaches it.  Under ``inference_mode`` or ``no_grad`` (the
executor) the calls are the kernels themselves, as before: the same
launches, in place.  Only f32 is trained: a bf16 backward raises.
Sequence-parallel attention (K14) has no backward: a ring over CUDA
tensors with grad enabled raises.

A model runs on a grid of devices (:meth:`_EncoderStack.place`): row
``b`` holds block ``b`` of the sequence, column ``j`` shard ``j`` of the
heads and MLP width (:func:`encoder_param_specs`, the JAX package's
tensor-parallel rules).  Unplaced it is one cell, itself.  With
``cfg.seq_mesh`` set (sequence parallelism, the JAX package's
long-document path) the rows are the devices of ``cfg.seq_axis``: the
activations stay cut along the sequence through every layer, each
block's embeddings read the positions from its offset (K6 over a view of
the position table), and attention is ring attention over the blocks
(:func:`~pathway_tpu_torch.ops.ring_attention.ring_attention_blocks`,
K14).  Over several shards each device computes its heads' q/k/v and
attention and its part of the MLP width; the out-projection and
``mlp_down`` partial products are summed on the row's first device, and
the bias, K4 and K5 follow once there.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.kernels.add_layer_norm import AddLayerNormFunction, add_layer_norm
from pathway_tpu_torch.kernels.attention import AttentionFunction, attention
from pathway_tpu_torch.kernels.bias_act import BiasActFunction, bias_act
from pathway_tpu_torch.kernels.cross_head import cross_head
from pathway_tpu_torch.kernels.embed_ln import EmbedLnFunction, embed_ln
from pathway_tpu_torch.kernels.pool_normalize import PoolNormalizeFunction, pool_normalize
from pathway_tpu_torch.ops.ring_attention import ring_attention_blocks

__all__ = [
    "EncoderConfig",
    "Embeddings",
    "SelfAttention",
    "EncoderBlock",
    "TextEncoderModel",
    "CrossEncoderModel",
    "encoder_param_specs",
    "MINILM_L6",
    "BGE_SMALL",
    "BGE_BASE",
    "BGE_LARGE",
    "E5_BASE",
    "BGE_RERANKER_BASE",
]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Architecture hyperparameters (BERT-style post-LN encoder)."""

    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 512
    type_vocab: int = 2
    pool: str = "mean"  # mean | cls
    normalize: bool = True  # L2-normalize sentence embedding
    num_labels: int = 0  # >0 => cross-encoder classification head
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.float32
    ln_eps: float = 1e-12
    #: tanh-approximated gelu; HF "gelu" is the exact erf form
    gelu_approx: bool = True
    #: sequence-parallel long-document attention: with a
    #: :class:`~pathway_tpu_torch.parallel.Mesh`, the sequence is cut over
    #: the devices of ``seq_axis`` and every attention is ring attention
    #: (K14); max_len still bounds the position table.  The mesh hashes
    #: by identity, so the config stays hashable.
    seq_mesh: Any = None
    seq_axis: str = "data"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


MINILM_L6 = EncoderConfig(hidden=384, layers=6, heads=12, mlp_dim=1536)
BGE_SMALL = EncoderConfig(hidden=384, layers=12, heads=12, mlp_dim=1536, pool="cls")
BGE_BASE = EncoderConfig(hidden=768, layers=12, heads=12, mlp_dim=3072, pool="cls")
BGE_LARGE = EncoderConfig(hidden=1024, layers=24, heads=16, mlp_dim=4096, pool="cls")
E5_BASE = EncoderConfig(hidden=768, layers=12, heads=12, mlp_dim=3072, pool="mean")
BGE_RERANKER_BASE = dataclasses.replace(BGE_BASE, num_labels=1, pool="cls", normalize=False)

#: std of the seeded random init (BERT's initializer_range)
_INIT_STD = 0.02


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, extra: tuple[nn.Parameter, ...] = ()) -> None:
    """BERT-style random init of ``model`` from ``seed``: normal(0, 0.02)
    matrices, embeddings and the ``extra`` parameters, zero biases, unit
    LayerNorm scales.  Drawn on the CPU so a seed gives the same weights on
    every device."""
    gen = torch.Generator().manual_seed(seed)

    def draw(w: torch.Tensor) -> None:
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32) * _INIT_STD)

    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Embedding)):
            draw(m.weight)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
    for w in extra:
        draw(w)


def _trains(*tensors: torch.Tensor | None) -> bool:
    """Whether a kernel call must go through its autograd Function: grad
    is enabled and one of ``tensors`` requires it."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _bias_act(y: torch.Tensor, bias: torch.Tensor, act: str = "none") -> torch.Tensor:
    """K4 on ``y`` in place (its Function when training)."""
    if _trains(y, bias):
        return BiasActFunction.apply(y, bias, act)
    return bias_act(y, bias, act)


def _dense(x: torch.Tensor, layer: nn.Linear, act: str = "none") -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)`` (+ activation): the weight cast to the
    activation type, the product rounded to it, then K4 adds the bias and
    applies ``act`` in place."""
    return _bias_act(F.linear(x, layer.weight.to(x.dtype)), layer.bias, act)


def _add_layer_norm(x: torch.Tensor, r: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=x.dtype)(x + r)`` through K5."""
    if _trains(x, r, ln.weight, ln.bias):
        return AddLayerNormFunction.apply(x, r, ln.weight, ln.bias, ln.eps)
    return add_layer_norm(x, r, ln.weight, ln.bias, ln.eps)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K1 (its Function when training)."""
    if _trains(q, k, v):
        return AttentionFunction.apply(q, k, v, mask)
    return attention(q, k, v, mask)


class SelfAttention(nn.Module):
    """The attention's dense layers; ``shards`` > 1 makes one model shard
    of them: ``heads / shards`` heads, the out-projection over their
    columns."""

    def __init__(self, cfg: EncoderConfig, device: torch.device | None = None, shards: int = 1):
        super().__init__()
        self.cfg = cfg
        self.heads = cfg.heads // shards
        width = self.heads * cfg.head_dim
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.query = nn.Linear(cfg.hidden, width, **kw)
        self.key = nn.Linear(cfg.hidden, width, **kw)
        self.value = nn.Linear(cfg.hidden, width, **kw)
        self.out = nn.Linear(width, cfg.hidden, **kw)

    def qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k, v ``[B, L, heads, head_dim]`` of ``x`` ``[B, L, hidden]``."""
        B, L, _ = x.shape
        heads = (B, L, self.heads, self.cfg.head_dim)
        return tuple(_dense(x, lin).view(heads) for lin in (self.query, self.key, self.value))

    def project(self, ctx: torch.Tensor) -> torch.Tensor:
        """The out-projection's product of ``ctx`` ``[B, L, heads, head_dim]``,
        without its bias: a partial sum over the heads of this shard."""
        B, L = ctx.shape[:2]
        return F.linear(ctx.reshape(B, L, -1), self.out.weight.to(ctx.dtype))


class EncoderBlock(nn.Module):
    """A post-LN block; ``shards`` > 1 makes one model shard of it (its
    heads and ``mlp_dim / shards`` of the MLP width)."""

    def __init__(self, cfg: EncoderConfig, device: torch.device | None = None, shards: int = 1):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.attention = SelfAttention(cfg, device, shards)
        self.attention_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps, **kw)
        self.mlp_up = nn.Linear(cfg.hidden, cfg.mlp_dim // shards, **kw)
        self.mlp_down = nn.Linear(cfg.mlp_dim // shards, cfg.hidden, **kw)
        self.mlp_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps, **kw)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """``mlp_down``'s product of the GELU'd ``mlp_up`` of ``x``, without
        ``mlp_down``'s bias: a partial sum over this shard's MLP width."""
        h = _dense(x, self.mlp_up, "gelu_tanh" if self.cfg.gelu_approx else "gelu_erf")
        return F.linear(h, self.mlp_down.weight.to(h.dtype))

    @property
    def device(self) -> torch.device:
        return self.mlp_up.weight.device

    @staticmethod
    def finish(x: torch.Tensor, partials: list, layer: nn.Linear, ln: nn.LayerNorm) -> torch.Tensor:
        """Sum the shards' partial products on ``x``'s device, add the
        layer's bias once (K4), then the residual LayerNorm (K5)."""
        a = partials[0]
        for p in partials[1:]:
            a = a + p.to(a.device)
        return _add_layer_norm(x, _bias_act(a, layer.bias), ln)

    @staticmethod
    def complete(shards: list["EncoderBlock"], x: torch.Tensor, ctx: list) -> torch.Tensor:
        """The block after its attention, over its model shards: ``ctx[j]``
        is shard ``j``'s attention output (on its device), ``x`` the
        block's input on the first shard's device, where the partial
        products are summed."""
        first = shards[0]
        parts = [blk.attention.project(c) for blk, c in zip(shards, ctx)]
        x = first.finish(x, parts, first.attention.out, first.attention_ln)
        parts = [blk.mlp(x.to(blk.device)) for blk in shards]
        return first.finish(x, parts, first.mlp_down, first.mlp_ln)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.complete([self], x, [_attention(*self.attention.qkv(x), mask)])


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden, **kw)
        self.position = nn.Embedding(cfg.max_len, cfg.hidden, **kw)
        self.token_type = nn.Embedding(cfg.type_vocab, cfg.hidden, **kw) if cfg.type_vocab else None
        self.ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps, **kw)

    def forward(
        self, ids: torch.Tensor, type_ids: torch.Tensor | None, offset: int = 0
    ) -> torch.Tensor:
        """K6: ids may arrive narrowed (int16) and type ids as uint8; the
        tokens sit at positions ``offset``, ``offset + 1``, ... (a block
        of a longer sequence)."""
        types = None if self.token_type is None else self.token_type.weight
        args = (ids, type_ids, self.word.weight, self.position.weight[offset:], types,
                self.ln.weight, self.ln.bias, self.ln.eps, self.cfg.dtype)
        if _trains(*args[2:7]):
            return EmbedLnFunction.apply(*args)
        return embed_ln(*args)


class _EncoderStack(nn.Module):
    """Embeddings + the post-LN blocks, shared by both model heads.

    Parameters are made on ``device`` (default ``"cuda"``; raises when no
    card is present) with a seeded random init drawn from a
    ``torch.Generator`` (``seed=None`` leaves them to a state dict loaded
    next); load real weights with ``load_state_dict``.  ``shards`` > 1
    makes one tensor-parallel shard (:meth:`place` makes them); ``grid``
    is the device grid to place the model on (default: ``device``, or the
    devices of ``cfg.seq_axis``).
    """

    def __init__(
        self, cfg: EncoderConfig, *, device: str | torch.device = "cuda", seed: int | None = 0,
        shards: int = 1, grid: list[list[torch.device]] | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, dev)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg, dev, shards))
        self._add_head(cfg, dev)
        if seed is not None:
            init_weights(self, seed)
        self._placement = None
        self._grid = None
        self._shards_ahead = False
        if shards == 1:
            seq = cfg.seq_mesh
            if grid is None:
                grid = [[dev]] if seq is None else [[d] for d in seq.devices_along(cfg.seq_axis)]
            self.place(grid)

    def _add_head(self, cfg: EncoderConfig, device: torch.device) -> None:
        """Make the head's parameters (before the seeded init draws them)."""

    @property
    def device(self) -> torch.device:
        """Where the output lands: the first cell's device (this model's
        own unless it is cut into model shards)."""
        cell = self.cells()[0][0] if self._grid else self
        return cell.embeddings.word.weight.device

    def cells(self) -> list[list["_EncoderStack"]]:
        """The device grid's models (:meth:`place`), this model where it
        is its own cell: the grid keeps None there, so that the model and
        its grid form no reference cycle and a dropped model frees its
        device memory at once."""
        return [[self if cell is None else cell for cell in row] for row in self._grid]

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def place(self, devices: list[list[torch.device]]) -> None:
        """Spread the model over a grid of devices: row ``b`` runs block
        ``b`` of the sequence (one row unless ``cfg.seq_mesh`` is set),
        column ``j`` shard ``j`` of the heads and MLP width.  Each
        distinct (shard, device) gets its weights once, cut from this
        model's by :func:`encoder_param_specs`; this model itself is the
        one shard on its own device.  Cut into shards, this model's own
        weights move to host memory, the source of the shards
        (``state_dict``, ``load_state_dict``), so each device holds only
        its shards.  ``load_state_dict`` places again."""
        n = len(devices[0])
        if any(len(row) != n for row in devices):
            raise ValueError(f"device grid rows of unequal length: {devices}")
        if self.cfg.heads % n or self.cfg.mlp_dim % n:
            raise ValueError(
                f"{n} model shards must divide heads {self.cfg.heads} and mlp_dim {self.cfg.mlp_dim}"
            )
        self._grid = None  # the old cells go before the new ones are made
        made: dict = {}
        state = specs = None
        grid = []
        for row in devices:
            cells = []
            for j, dev in enumerate(row):
                dev = resolve_device(dev)
                if (j, dev) not in made:
                    if n == 1 and dev == self.device:
                        made[j, dev] = None  # this model
                    else:
                        if state is None:
                            state, specs = self.state_dict(), encoder_param_specs(self)
                        cfg = dataclasses.replace(self.cfg, seq_mesh=None)
                        part = type(self)(cfg, device=dev, seed=None, shards=n)
                        part.load_state_dict(
                            {k: _shard(t, specs[k], j, n) for k, t in state.items()}
                        )
                        made[j, dev] = part.eval()
                cells.append(made[j, dev])
            grid.append(cells)
        if n > 1:
            self.to("cpu")
        self._placement = [list(row) for row in devices]
        self._grid = grid

    def mark_shards_trained(self) -> None:
        """Note that the model shards' weights have moved past this model's
        host copy (a train step updated them): :meth:`state_dict` gathers
        them back before it reads the copy, so a step itself copies
        nothing to the host."""
        self._shards_ahead = len(self.cells()[0]) > 1

    def state_dict(self, *args, **kwargs):
        if self._shards_ahead:
            self._gather_shards()
        return super().state_dict(*args, **kwargs)

    @torch.no_grad()
    def _gather_shards(self) -> None:
        """Write the model shards' weights into the host copy: split
        tensors concatenated, replicated ones from the first shard."""
        self._shards_ahead = False
        cells = self.cells()[0]
        for name, spec in encoder_param_specs(self).items():
            dims = [d for d, axis in enumerate(spec) if axis is not None]
            parts = [cell.get_parameter(name).cpu() for cell in cells]  # pw-j002: once per state_dict
            self.get_parameter(name).copy_(torch.cat(parts, dims[0]) if dims else parts[0])

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self._shards_ahead = False
        result = super().load_state_dict(state_dict, strict, assign)
        if self._placement is not None:
            self.place(self._placement)
        return result

    def hidden_blocks(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None
    ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """The last block's output in ``cfg.dtype``, cut along the
        sequence as the grid's rows cut it (block ``b`` ``[B, L/n,
        hidden]`` on row ``b``'s first device), and the uint8 mask cut the
        same way."""
        grid = self.cells()
        n_seq, n_tp = len(grid), len(grid[0])
        L = ids.shape[1]
        if L % n_seq:
            raise ValueError(f"sequence length {L} must divide by the {n_seq} sequence blocks")
        lb = L // n_seq
        devs = [[cell.device for cell in row] for row in grid]
        layers = [[cell.blocks() for cell in row] for row in grid]

        def block(t: torch.Tensor | None, b: int, dev: torch.device) -> torch.Tensor | None:
            return None if t is None else t[:, b * lb : (b + 1) * lb].to(dev).contiguous()

        masks = [[block(mask, b, dev) for dev in devs[b]] for b in range(n_seq)]
        xs = [row[0].embeddings(block(ids, b, devs[b][0]), block(type_ids, b, devs[b][0]), b * lb)
              for b, row in enumerate(grid)]
        for i in range(self.cfg.layers):
            # every shard's q/k/v of every block, then attention shard by shard
            qkv = [[layers[b][j][i].attention.qkv(xs[b].to(devs[b][j])) for j in range(n_tp)]
                   for b in range(n_seq)]
            ctx = [[None] * n_tp for _ in range(n_seq)]
            for j in range(n_tp):
                if self.cfg.seq_mesh is None:
                    ctx[0][j] = _attention(*qkv[0][j], masks[0][j])
                else:
                    col = [qkv[b][j] for b in range(n_seq)]
                    if _trains(*col[0]) and col[0][0].device.type != "cpu":
                        raise NotImplementedError(
                            "training over a sequence mesh: ring attention (K14) has no backward kernel")
                    outs = ring_attention_blocks(*zip(*col), [masks[b][j] for b in range(n_seq)])
                    for b in range(n_seq):
                        ctx[b][j] = outs[b]
            for b in range(n_seq):
                xs[b] = EncoderBlock.complete([layers[b][j][i] for j in range(n_tp)], xs[b], ctx[b])
        return xs, [row[0] for row in masks]


class TextEncoderModel(_EncoderStack):
    """Sentence encoder: token ids [B, L] + mask [B, L] -> pooled
    (optionally normalized) f32 embedding [B, hidden]; the tail is K7, on
    the first cell's device: the CLS row of the first sequence block, or the
    masked mean over all blocks gathered there."""

    def pool_inputs(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """What the tail pools, on the first cell's device: the last
        block's output ``[B, L, hidden]`` in ``cfg.dtype`` (for CLS only the
        first sequence block) and its uint8 mask.  :meth:`forward` pools it
        with K7; ``ShardedKnnIndex.add_pooled_device`` pools it straight into
        the index (the ingest tail)."""
        xs, masks = self.hidden_blocks(ids, mask.to(torch.uint8), type_ids)
        if self.cfg.pool == "cls" or len(xs) == 1:
            return xs[0].to(self.device), masks[0].to(self.device)
        return (torch.cat([x.to(self.device) for x in xs], dim=1),
                torch.cat([m.to(self.device) for m in masks], dim=1))

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        x, m = self.pool_inputs(ids, mask, type_ids)
        if _trains(x):
            return PoolNormalizeFunction.apply(x, m, self.cfg.pool, self.cfg.normalize)
        return pool_normalize(x, m, self.cfg.pool, self.cfg.normalize)


class CrossEncoderModel(_EncoderStack):
    """(query, doc) pair scorer: encoder + classification head -> [B]
    logits when ``num_labels <= 1``, else [B, num_labels] (the JAX
    package's ``CrossEncoderModel``, ``encoder.py:205-231``).

    The head runs on the first cell's device, on the CLS rows of the first
    sequence block (a strided view of the last hidden state): the
    ``pooler`` Dense + tanh and the ``classifier`` Dense in f32, bias
    included, are one launch of the head kernel (``cross_head``, B8).
    Where autograd asks for a gradient, the head is the pooler's product,
    K4 with ``act="tanh"`` through its Function, and the classifier's
    ``F.linear`` in f32 (the reference never trains the cross-encoder, and
    the head kernel has no backward).
    """

    def _add_head(self, cfg: EncoderConfig, device: torch.device) -> None:
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.pooler = nn.Linear(cfg.hidden, cfg.hidden, **kw)
        self.classifier = nn.Linear(cfg.hidden, max(cfg.num_labels, 1), **kw)

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        xs, _ = self.hidden_blocks(ids, mask.to(torch.uint8), type_ids)
        head = self.cells()[0][0]
        cls = xs[0][:, 0].to(self.device)
        params = (head.pooler.weight, head.pooler.bias, head.classifier.weight, head.classifier.bias)
        if _trains(cls, *params):
            h = _dense(cls, head.pooler, "tanh")
            logits = F.linear(h.float(), head.classifier.weight.float(), head.classifier.bias.float())
        else:
            logits = cross_head(cls, *params)
        return logits[:, 0] if logits.shape[1] == 1 else logits


# ---------------------------------------------------------------------------
# Tensor-parallel sharding rules


def encoder_param_specs(model: nn.Module, model_axis: str = "model") -> dict[str, tuple]:
    """``{parameter name: spec}`` for a model's ``state_dict``, the JAX
    package's ``encoder_param_specs`` (``pathway_tpu/models/encoder.py:238``)
    on the port's names and ``[out, in]`` layouts: a spec names, for each
    dimension, ``model_axis`` where the parameter is split over the model
    shards and None where not, ``()`` for a replicated parameter.
    ``query``/``key``/``value`` weights and biases split by heads (output
    rows), the attention ``out`` weight by heads (input columns),
    ``mlp_up`` weight and bias by output rows, ``mlp_down`` weight by
    input columns; everything else is replicated."""
    specs = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        layer, leaf = parts[-2] if len(parts) > 1 else "", parts[-1]
        spec: tuple = ()
        if layer in ("query", "key", "value") or (layer == "mlp_up"):
            spec = (model_axis,) + (None,) * (t.dim() - 1)
        elif leaf == "weight" and (layer == "mlp_down" or name.endswith("attention.out.weight")):
            spec = (None, model_axis)
        specs[name] = spec
    return specs


def _shard(t: torch.Tensor, spec: tuple, j: int, n: int) -> torch.Tensor:
    """Part ``j`` of ``n`` of ``t`` along the dimension ``spec`` splits."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            return t.chunk(n, dim)[j].contiguous()
    return t
