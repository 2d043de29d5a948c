"""SigLIP-class dual (image + text) encoder in PyTorch (counterpart of
``pathway_tpu/models/vision.py``).

A ViT image tower and the port's text tower projected into one embedding
space, with the same configuration, parameter names and numerics as the
flax modules, so the same weights (``models/convert.py``) give the same
outputs:

- the patch embed is flax's stride-``patch`` ``nn.Conv`` with ``"SAME"``
  padding: K8 ``patchify`` cuts NHWC images into patch rows in the HWIO
  kernel's ``(kh, kw, c)`` order, a bias-free ``F.linear`` (cuBLAS) takes
  the product in the activation type, and K4 ``bias_act`` adds the bias
  and then the position embedding, rounding after each add as flax does;
- ``layers`` post-LN :class:`~pathway_tpu_torch.models.encoder.EncoderBlock`
  over every patch (an all-ones mask), through K1, K4 and K5 as on the
  text paths;
- the tail is K9 ``vision_head``: the f32 mean of the patch rows (kept in
  f32, unlike the text tower's pooling), the f32 ``projection`` and the
  L2 normalise with eps 1e-12;
- the dual encoder's logits ``img @ txt.T * exp(logit_scale) + logit_bias``
  are K10 ``dual_logits``.

Images whose sides are not multiples of ``patch`` are padded as flax's
``"SAME"`` pads them; where that grid is not ``image_size // patch`` patches
a side, the position embedding does not fit (the JAX model fails on the
broadcast) and the tower raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.kernels.bias_act import bias_act
from pathway_tpu_torch.kernels.dual_logits import dual_logits
from pathway_tpu_torch.kernels.patchify import patch_grid, patchify
from pathway_tpu_torch.kernels.vision_head import vision_head
from pathway_tpu_torch.models.encoder import (
    EncoderBlock,
    EncoderConfig,
    TextEncoderModel,
    init_weights,
)

__all__ = ["VisionConfig", "VisionEncoderModel", "DualEncoderModel", "SIGLIP_BASE"]

#: image channels (RGB), the conv kernel's input width
CHANNELS = 3


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch: int = 16
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    embed_dim: int = 768  # shared space
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    def as_encoder_cfg(self) -> EncoderConfig:
        return EncoderConfig(
            hidden=self.hidden,
            layers=self.layers,
            heads=self.heads,
            mlp_dim=self.mlp_dim,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
        )


SIGLIP_BASE = VisionConfig()


class VisionEncoderModel(nn.Module):
    """ViT tower: images ``[B, H, W, 3]`` (NHWC, f32 or uint8) -> f32
    ``[B, embed_dim]``, mean-pooled, projected and L2-normalized.

    Parameters are made on ``device`` (default ``"cuda"``; raises when no
    card is present) with a seeded random init; load real weights with
    ``load_state_dict`` (``models/convert.py``).  ``patch_embed.weight`` is
    ``[hidden, patch * patch * 3]`` with columns in ``(kh, kw, c)`` order.
    """

    def __init__(self, cfg: VisionConfig, *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = {"device": dev, "dtype": cfg.param_dtype}
        self.patch_embed = nn.Linear(cfg.patch * cfg.patch * CHANNELS, cfg.hidden, **kw)
        self.pos_embed = nn.Parameter(torch.empty((1, cfg.n_patches, cfg.hidden), **kw))
        ecfg = cfg.as_encoder_cfg()
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderBlock(ecfg, dev))
        self.projection = nn.Linear(cfg.hidden, cfg.embed_dim, **kw)
        init_weights(self, seed, extra=(self.pos_embed,))

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def patch_embeddings(self, images: torch.Tensor) -> torch.Tensor:
        """The conv + bias + position embedding: ``[B, P, hidden]`` in
        ``cfg.dtype``."""
        cfg = self.cfg
        if images.dim() != 4 or images.shape[-1] != CHANNELS:
            raise ValueError(f"images must be [B, H, W, {CHANNELS}], got {tuple(images.shape)}")
        B, H, W, _ = images.shape
        gh, gw, _, _ = patch_grid(H, W, cfg.patch)
        if gh * gw != cfg.n_patches:
            raise ValueError(
                f"{H}x{W} images give a {gh}x{gw} grid of {cfg.patch}-pixel patches; the "
                f"position embedding holds {cfg.n_patches} (image_size {cfg.image_size})"
            )
        x = F.linear(patchify(images, cfg.patch, cfg.dtype), self.patch_embed.weight.to(cfg.dtype))
        x = bias_act(x, self.patch_embed.bias, "none", pos=self.pos_embed[0])
        return x.view(B, cfg.n_patches, cfg.hidden)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embeddings(images)
        mask = torch.ones(x.shape[:2], dtype=torch.uint8, device=x.device)
        for block in self.blocks():
            x = block(x, mask)
        return vision_head(x, self.projection.weight, self.projection.bias)


class DualEncoderModel(nn.Module):
    """SigLIP-style contrastive pair: :meth:`embed_image` /
    :meth:`embed_text` entry points plus a combined call returning the
    pairwise logit matrix ``[B_images, B_texts]`` (f32).  The text tower
    always normalizes, as in the JAX package."""

    def __init__(
        self, vision_cfg: VisionConfig, text_cfg: EncoderConfig, *,
        device: str | torch.device = "cuda", seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.vision_cfg = vision_cfg
        self.text_cfg = dataclasses.replace(text_cfg, normalize=True)
        self.vision = VisionEncoderModel(vision_cfg, device=dev, seed=seed)
        self.text = TextEncoderModel(self.text_cfg, device=dev, seed=seed + 1)
        self.logit_scale = nn.Parameter(torch.tensor(1.0, dtype=torch.float32, device=dev))
        self.logit_bias = nn.Parameter(torch.tensor(0.0, dtype=torch.float32, device=dev))

    def embed_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.vision(images)

    def embed_text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.text(ids, mask)

    def forward(self, images: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        img = self.embed_image(images)
        txt = self.embed_text(ids, mask)
        return dual_logits(img, txt, self.logit_scale, self.logit_bias)
