"""Weight bridge: flax encoder parameters -> the port's ``state_dict``.

Maps the parameter tree of ``pathway_tpu.models.TextEncoderModel`` or
``CrossEncoderModel`` (nested dicts of arrays, as ``model.init`` returns
them or as ``pathway_tpu/models/convert.py`` builds them from an HF
checkpoint) onto :class:`pathway_tpu_torch.models.TextEncoderModel` or
:class:`~pathway_tpu_torch.models.CrossEncoderModel`, so both packages run
the same weights.  Layouts (``pathway_tpu/models/convert.py:11-33``):

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
==========================================  ================================

The loader of HF checkpoint directories waits until a checkpoint is in
the repository.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pathway_tpu_torch.models.encoder import EncoderConfig

__all__ = ["state_dict_from_flax"]


def state_dict_from_flax(
    params: Mapping[str, Any], cfg: EncoderConfig, *, cross: bool | None = None
) -> dict[str, torch.Tensor]:
    """``state_dict`` for ``TextEncoderModel(cfg)``, or for
    ``CrossEncoderModel(cfg)`` when ``cross`` is set (by default when
    ``cfg.num_labels > 0``), from a flax parameter tree (with or without
    the outer ``{"params": ...}``).  The bi-encoder's tree needs no
    ``pooler``/``classifier``; the cross-encoder's must have both."""
    if cross is None:
        cross = cfg.num_labels > 0
    p = params.get("params", params)
    out: dict[str, torch.Tensor] = {}

    def put(name: str, arr: Any) -> None:
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def ln(prefix: str, leaf: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", leaf["scale"])
        put(f"{prefix}.bias", leaf["bias"])

    def dense(prefix: str, leaf: Mapping[str, Any]) -> None:
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kernel.ndim == 3 and prefix.endswith(".out"):
            kernel = kernel.reshape(-1, kernel.shape[-1])  # [heads*hd, hidden]
        else:
            kernel = kernel.reshape(kernel.shape[0], -1)  # [in, out]
        put(f"{prefix}.weight", kernel.T)
        put(f"{prefix}.bias", np.asarray(leaf["bias"]).reshape(-1))

    emb = p["embeddings"]
    put("embeddings.word.weight", emb["word"]["embedding"])
    put("embeddings.position.weight", emb["position"]["embedding"])
    if cfg.type_vocab:
        put("embeddings.token_type.weight", emb["type"]["embedding"])
    ln("embeddings.ln", emb["ln"])
    for i in range(cfg.layers):
        layer = p[f"layer_{i}"]
        pre = f"layer_{i}"
        for name in ("query", "key", "value", "out"):
            dense(f"{pre}.attention.{name}", layer["attention"][name])
        ln(f"{pre}.attention_ln", layer["attention_ln"])
        dense(f"{pre}.mlp_up", layer["mlp_up"])
        dense(f"{pre}.mlp_down", layer["mlp_down"])
        ln(f"{pre}.mlp_ln", layer["mlp_ln"])
    if cross:
        dense("pooler", p["pooler"])
        dense("classifier", p["classifier"])
    return out
