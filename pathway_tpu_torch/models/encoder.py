"""BERT-family text encoders in PyTorch (counterpart of
``pathway_tpu/models/encoder.py``).

Same configuration, presets, parameter names and numerics as the flax
modules, so the same weights (``models/convert.py``) give the same
embeddings:

- f32 parameters, activations in ``cfg.dtype`` (bf16 for the presets);
  every dense layer casts its parameters to the activation type per call
  and adds its bias after the product, as flax ``Dense(dtype=...)`` does;
- the word + position (+ type) embedding sum in the activation type, in
  flax's order;
- post-LN blocks, LayerNorm statistics in f32 with ``ln_eps`` (1e-12);
- tanh GELU unless ``gelu_approx=False``;
- pooled embedding L2-normalized in f32 with eps 1e-12.

The attention core runs through kernel K1 (``kernels/attention.py``).
The sequence-parallel ring-attention branch and ``CrossEncoderModel``
wait for later slices (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.kernels.attention import attention
from pathway_tpu_torch.ops.pooling import cls_pool, masked_mean_pool

__all__ = [
    "EncoderConfig",
    "Embeddings",
    "SelfAttention",
    "EncoderBlock",
    "TextEncoderModel",
    "MINILM_L6",
    "BGE_SMALL",
    "BGE_BASE",
    "BGE_LARGE",
    "E5_BASE",
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

#: std of the seeded random init (BERT's initializer_range)
_INIT_STD = 0.02


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)``: params cast to the activation type,
    product rounded to it, then the bias added."""
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=x.dtype)``: f32 statistics, result cast back."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(x.dtype)


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
        x = _layer_norm(x + self.attention(x, mask), self.attention_ln)
        h = _dense(x, self.mlp_up)
        h = F.gelu(h, approximate="tanh" if self.cfg.gelu_approx else "none")
        h = _dense(h, self.mlp_down)
        return _layer_norm(x + h, self.mlp_ln)


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
        dt = self.cfg.dtype
        # ids may arrive narrowed (int16): F.embedding takes int64
        ids = ids.long()
        emb = F.embedding(ids, self.word.weight).to(dt)
        emb = emb + self.position.weight[: ids.shape[1]].to(dt)[None]
        if self.token_type is not None:
            t = torch.zeros_like(ids) if type_ids is None else type_ids.long()
            emb = emb + F.embedding(t, self.token_type.weight).to(dt)
        return _layer_norm(emb, self.ln)


class TextEncoderModel(nn.Module):
    """Sentence encoder: token ids [B, L] + mask [B, L] -> pooled
    (optionally normalized) f32 embedding [B, hidden].

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
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """BERT-style random init from ``seed``: normal(0, 0.02) matrices
        and embeddings, zero biases, unit LayerNorm scales.  Drawn on the
        CPU so a seed gives the same weights on every device."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.randn(m.weight.shape, generator=gen, dtype=torch.float32)
                m.weight.copy_(w * _INIT_STD)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, type_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        cfg = self.cfg
        mask = mask.to(torch.uint8)
        x = self.embeddings(ids, type_ids)
        for block in self.blocks():
            x = block(x, mask)
        pooled = cls_pool(x) if cfg.pool == "cls" else masked_mean_pool(x, mask)
        pooled = pooled.float()
        if cfg.normalize:
            norm = torch.sqrt(torch.sum(pooled**2, dim=-1, keepdim=True))
            pooled = pooled / torch.clamp(norm, min=1e-12)
        return pooled
