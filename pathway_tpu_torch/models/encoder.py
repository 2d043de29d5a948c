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

Everything but the dense products runs through the port's kernels:
K6 ``embed_ln`` (embeddings), K1 ``attention``, K4 ``bias_act`` (every
dense layer's bias, the GELU and the cross-encoder pooler's tanh), K5
``add_layer_norm`` (both residual LayerNorms of a block) and K7
``pool_normalize`` (the sentence encoder's tail).  The products are
``F.linear`` without bias (cuBLAS), as the JAX package leaves them to
XLA.  The sequence-parallel ring-attention branch waits for the
multi-GPU slice (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.kernels.add_layer_norm import add_layer_norm
from pathway_tpu_torch.kernels.attention import attention
from pathway_tpu_torch.kernels.bias_act import bias_act
from pathway_tpu_torch.kernels.embed_ln import embed_ln
from pathway_tpu_torch.kernels.pool_normalize import pool_normalize

__all__ = [
    "EncoderConfig",
    "Embeddings",
    "SelfAttention",
    "EncoderBlock",
    "TextEncoderModel",
    "CrossEncoderModel",
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


def _dense(x: torch.Tensor, layer: nn.Linear, act: str = "none") -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)`` (+ activation): the weight cast to the
    activation type, the product rounded to it, then K4 adds the bias and
    applies ``act`` in place."""
    return bias_act(F.linear(x, layer.weight.to(x.dtype)), layer.bias, act)


def _add_layer_norm(x: torch.Tensor, r: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=x.dtype)(x + r)`` through K5."""
    return add_layer_norm(x, r, ln.weight, ln.bias, ln.eps)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.query = nn.Linear(cfg.hidden, cfg.hidden, **kw)
        self.key = nn.Linear(cfg.hidden, cfg.hidden, **kw)
        self.value = nn.Linear(cfg.hidden, cfg.hidden, **kw)
        self.out = nn.Linear(cfg.hidden, cfg.hidden, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        heads = (B, L, cfg.heads, cfg.head_dim)
        q = _dense(x, self.query).view(heads)
        k = _dense(x, self.key).view(heads)
        v = _dense(x, self.value).view(heads)
        ctx = attention(q, k, v, mask)
        return _dense(ctx.reshape(B, L, cfg.hidden), self.out)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.attention = SelfAttention(cfg, device)
        self.attention_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps, **kw)
        self.mlp_up = nn.Linear(cfg.hidden, cfg.mlp_dim, **kw)
        self.mlp_down = nn.Linear(cfg.mlp_dim, cfg.hidden, **kw)
        self.mlp_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = _add_layer_norm(x, self.attention(x, mask), self.attention_ln)
        h = _dense(x, self.mlp_up, "gelu_tanh" if self.cfg.gelu_approx else "gelu_erf")
        h = _dense(h, self.mlp_down)
        return _add_layer_norm(x, h, self.mlp_ln)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden, **kw)
        self.position = nn.Embedding(cfg.max_len, cfg.hidden, **kw)
        self.token_type = nn.Embedding(cfg.type_vocab, cfg.hidden, **kw) if cfg.type_vocab else None
        self.ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps, **kw)

    def forward(self, ids: torch.Tensor, type_ids: torch.Tensor | None) -> torch.Tensor:
        """K6: ids may arrive narrowed (int16) and type ids as uint8."""
        types = None if self.token_type is None else self.token_type.weight
        return embed_ln(
            ids, type_ids, self.word.weight, self.position.weight, types,
            self.ln.weight, self.ln.bias, self.ln.eps, self.cfg.dtype,
        )


class _EncoderStack(nn.Module):
    """Embeddings + the post-LN blocks, shared by both model heads.

    Parameters are made on ``device`` (default ``"cuda"``; raises when no
    card is present) with a seeded random init drawn from a
    ``torch.Generator``; load real weights with ``load_state_dict``.
    """

    def __init__(self, cfg: EncoderConfig, *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, dev)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg, dev))
        self._add_head(cfg, dev)
        init_weights(self, seed)

    def _add_head(self, cfg: EncoderConfig, device: torch.device) -> None:
        """Make the head's parameters (before the seeded init draws them)."""

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def hidden_states(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None
    ) -> torch.Tensor:
        """The last block's output ``[B, L, hidden]`` in ``cfg.dtype``;
        ``mask`` as uint8."""
        x = self.embeddings(ids, type_ids)
        for block in self.blocks():
            x = block(x, mask)
        return x


class TextEncoderModel(_EncoderStack):
    """Sentence encoder: token ids [B, L] + mask [B, L] -> pooled
    (optionally normalized) f32 embedding [B, hidden]; the tail is K7."""

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        mask = mask.to(torch.uint8)
        x = self.hidden_states(ids, mask, type_ids)
        return pool_normalize(x, mask, self.cfg.pool, self.cfg.normalize)


class CrossEncoderModel(_EncoderStack):
    """(query, doc) pair scorer: encoder + classification head -> [B]
    logits when ``num_labels <= 1``, else [B, num_labels] (the JAX
    package's ``CrossEncoderModel``, ``encoder.py:205-231``).

    The CLS row goes through the ``pooler`` Dense + tanh (a bf16 product,
    then K4 with ``act="tanh"``) and the ``classifier`` Dense in f32.  The
    classifier is a ``[B, hidden] x [hidden, labels]`` f32 product that
    the JAX package computes outside any fused program; it stays
    ``F.linear`` in f32, bias included.
    """

    def _add_head(self, cfg: EncoderConfig, device: torch.device) -> None:
        kw = {"device": device, "dtype": cfg.param_dtype}
        self.pooler = nn.Linear(cfg.hidden, cfg.hidden, **kw)
        self.classifier = nn.Linear(cfg.hidden, max(cfg.num_labels, 1), **kw)

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        x = self.hidden_states(ids, mask.to(torch.uint8), type_ids)
        h = _dense(x[:, 0], self.pooler, "tanh")
        logits = F.linear(h.float(), self.classifier.weight.float(), self.classifier.bias.float())
        return logits[:, 0] if logits.shape[1] == 1 else logits
