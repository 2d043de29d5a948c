"""Weight bridge: flax encoder parameters -> the port's ``state_dict``.

Maps the parameter tree of ``pathway_tpu.models.TextEncoderModel`` or
``CrossEncoderModel`` (nested dicts of arrays, as ``model.init`` returns
them or as ``pathway_tpu/models/convert.py`` builds them from an HF
checkpoint) onto :class:`pathway_tpu_torch.models.TextEncoderModel` or
:class:`~pathway_tpu_torch.models.CrossEncoderModel`, and the trees of
``pathway_tpu.models.vision``'s ``VisionEncoderModel`` and
``DualEncoderModel`` onto their counterparts, so both packages run the
same weights.  Layouts (``pathway_tpu/models/convert.py:11-33`` for the
text encoders):

==========================================  ================================
flax leaf                                   torch parameter
==========================================  ================================
``embeddings/{word,position}/embedding``    ``embeddings.{..}.weight``
``embeddings/type/embedding``              ``embeddings.token_type.weight``
``*/ln|attention_ln|mlp_ln/{scale,bias}``   ``*.{weight,bias}``
``attention/{query,key,value}/kernel``      ``.weight`` = kernel
  ``[hidden, heads, head_dim]``               ``.reshape(hidden, -1).T``
``attention/{query,key,value}/bias``        ``.bias`` = bias ``.reshape(-1)``
``attention/out/kernel``                    ``.weight`` = kernel
  ``[heads, head_dim, hidden]``               ``.reshape(-1, hidden).T``
``mlp_up|mlp_down/kernel`` ``[in, out]``    ``.weight`` = kernel ``.T``
``pooler|classifier/kernel`` ``[in, out]``  ``.weight`` = kernel ``.T``
  (cross-encoder only, top level)             ``.bias`` = bias
``patch_embed/kernel`` (vision, HWIO        ``patch_embed.weight`` = kernel
  ``[p, p, 3, hidden]``)                      ``.reshape(p * p * 3, hidden).T``
                                              (columns in ``(kh, kw, c)``
                                              order, as K8 writes them)
``patch_embed/bias``, ``projection/bias``   ``.bias``
``pos_embed`` ``[1, P, hidden]``            ``pos_embed``, as it is
``projection/kernel`` ``[hidden, embed]``   ``projection.weight`` = kernel ``.T``
``vision/...``, ``text/...`` (dual)         ``vision.*``, ``text.*``, as above
``logit_scale``, ``logit_bias`` (dual)      0-d ``logit_scale``, ``logit_bias``
==========================================  ================================

The loaders of HF and SigLIP checkpoint directories wait until a
checkpoint is in the repository.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.models.vision import VisionConfig

__all__ = ["state_dict_from_flax", "vision_state_dict_from_flax", "dual_state_dict_from_flax"]

StateDict = dict[str, torch.Tensor]


def _put(out: StateDict, name: str, arr: Any) -> None:
    out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))


def _ln(out: StateDict, prefix: str, leaf: Mapping[str, Any]) -> None:
    _put(out, f"{prefix}.weight", leaf["scale"])
    _put(out, f"{prefix}.bias", leaf["bias"])


def _dense(out: StateDict, prefix: str, leaf: Mapping[str, Any]) -> None:
    kernel = np.asarray(leaf["kernel"], np.float32)
    if kernel.ndim == 4 or (kernel.ndim == 3 and prefix.endswith(".out")):
        # conv HWIO [p, p, c, hidden] -> [p*p*c, hidden], rows in (kh, kw, c)
        # order; attention out [heads, hd, hidden] -> [heads*hd, hidden]
        kernel = kernel.reshape(-1, kernel.shape[-1])
    else:
        kernel = kernel.reshape(kernel.shape[0], -1)  # [in, out]
    _put(out, f"{prefix}.weight", kernel.T)
    _put(out, f"{prefix}.bias", np.asarray(leaf["bias"]).reshape(-1))


def _blocks(out: StateDict, p: Mapping[str, Any], layers: int, prefix: str = "") -> None:
    """The ``layer_{i}`` post-LN blocks of either tower."""
    for i in range(layers):
        layer = p[f"layer_{i}"]
        pre = f"{prefix}layer_{i}"
        for name in ("query", "key", "value", "out"):
            _dense(out, f"{pre}.attention.{name}", layer["attention"][name])
        _ln(out, f"{pre}.attention_ln", layer["attention_ln"])
        _dense(out, f"{pre}.mlp_up", layer["mlp_up"])
        _dense(out, f"{pre}.mlp_down", layer["mlp_down"])
        _ln(out, f"{pre}.mlp_ln", layer["mlp_ln"])


def _tree(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params.get("params", params)


def state_dict_from_flax(
    params: Mapping[str, Any], cfg: EncoderConfig, *, cross: bool | None = None
) -> StateDict:
    """``state_dict`` for ``TextEncoderModel(cfg)``, or for
    ``CrossEncoderModel(cfg)`` when ``cross`` is set (by default when
    ``cfg.num_labels > 0``), from a flax parameter tree (with or without
    the outer ``{"params": ...}``).  The bi-encoder's tree needs no
    ``pooler``/``classifier``; the cross-encoder's must have both."""
    if cross is None:
        cross = cfg.num_labels > 0
    p = _tree(params)
    out: StateDict = {}
    emb = p["embeddings"]
    _put(out, "embeddings.word.weight", emb["word"]["embedding"])
    _put(out, "embeddings.position.weight", emb["position"]["embedding"])
    if cfg.type_vocab:
        _put(out, "embeddings.token_type.weight", emb["type"]["embedding"])
    _ln(out, "embeddings.ln", emb["ln"])
    _blocks(out, p, cfg.layers)
    if cross:
        _dense(out, "pooler", p["pooler"])
        _dense(out, "classifier", p["classifier"])
    return out


def vision_state_dict_from_flax(params: Mapping[str, Any], cfg: VisionConfig) -> StateDict:
    """``state_dict`` for ``VisionEncoderModel(cfg)`` from the flax
    ``VisionEncoderModel``'s parameter tree."""
    p = _tree(params)
    out: StateDict = {}
    _dense(out, "patch_embed", p["patch_embed"])
    _put(out, "pos_embed", p["pos_embed"])
    _blocks(out, p, cfg.layers)
    _dense(out, "projection", p["projection"])
    return out


def dual_state_dict_from_flax(
    params: Mapping[str, Any], vision_cfg: VisionConfig, text_cfg: EncoderConfig
) -> StateDict:
    """``state_dict`` for ``DualEncoderModel(vision_cfg, text_cfg)`` from the
    flax ``DualEncoderModel``'s tree (``vision``, ``text``, ``logit_scale``,
    ``logit_bias``)."""
    p = _tree(params)
    out: StateDict = {}
    for name, arr in vision_state_dict_from_flax(p["vision"], vision_cfg).items():
        out[f"vision.{name}"] = arr
    for name, arr in state_dict_from_flax(p["text"], text_cfg, cross=False).items():
        out[f"text.{name}"] = arr
    _put(out, "logit_scale", p["logit_scale"])
    _put(out, "logit_bias", p["logit_bias"])
    return out
