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

A local HuggingFace BERT-family checkpoint directory (``config.json``,
``model.safetensors`` or ``pytorch_model.bin``, ``vocab.txt``) loads
without flax (:func:`load_encoder`, as ``pathway_tpu/models/convert.py:
54-197`` loads it for the JAX package): torch's ``nn.Linear`` keeps HF's
``[out, in]`` layout, so :func:`convert_bert_checkpoint` renames and
copies, and the layout table above is what the flax route goes through.
``model.safetensors`` is read by the port's own reader
(:func:`load_safetensors`; the ``safetensors`` package is not needed),
and :func:`save_safetensors` writes the same format.  The JAX package
has no SigLIP checkpoint loader, so neither has the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from pathway_tpu_torch.models.encoder import CrossEncoderModel, EncoderConfig, TextEncoderModel
from pathway_tpu_torch.models.vision import VisionConfig
from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer

__all__ = [
    "state_dict_from_flax",
    "vision_state_dict_from_flax",
    "dual_state_dict_from_flax",
    "load_safetensors",
    "save_safetensors",
    "load_state_dict",
    "config_from_hf",
    "convert_bert_checkpoint",
    "load_encoder",
]

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


# ---------------------------------------------------------------------------
# HF checkpoint directories

#: safetensors type names -> little-endian numpy types (BF16 is widened)
_ST_TYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_TYPES.items()}


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a ``.safetensors`` file: an 8-byte little-endian header
    length, a JSON header ``{name: {dtype, shape, data_offsets}}``, then
    the raw little-endian bytes.  F32/F16/F64 and the integer types come
    back as they are stored (views of one buffer); BF16 is widened to
    f32, exactly, since numpy has no bfloat16."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(n)))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - int(n))
        f.readinto(data)
    out: dict[str, np.ndarray] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        kind = entry["dtype"]
        if kind == "BF16":
            raw = np.frombuffer(data, "<u2", (end - begin) // 2, begin)
            arr = (raw.astype(np.uint32) << 16).view(np.float32)
        elif kind in _ST_TYPES:
            dt = np.dtype(_ST_TYPES[kind])
            arr = np.frombuffer(data, dt, (end - begin) // dt.itemsize, begin)
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported type {kind}")
        out[name] = arr.reshape(shape)
    return out


def save_safetensors(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """Write ``arrays`` (numpy, of the types :func:`load_safetensors`
    reads, BF16 aside) as a ``.safetensors`` file, in name order, the
    header padded with spaces to 8 bytes as the format's writers do."""
    header: dict[str, Any] = {}
    blobs = []
    offset = 0
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if dt not in _ST_NAMES:
            raise ValueError(f"tensor {name!r}: numpy type {arr.dtype} has no safetensors name here")
        blob = arr.astype(dt, copy=False).tobytes()
        header[name] = {"dtype": _ST_NAMES[dt], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(np.uint64(len(text)).astype("<u8").tobytes())
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_state_dict(model_dir: str) -> dict[str, np.ndarray]:
    """A checkpoint directory's weights as numpy arrays:
    ``model.safetensors`` through :func:`load_safetensors`, else
    ``pytorch_model.bin`` through ``torch.load(weights_only=True)``."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        return load_safetensors(st_path)
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {
            k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in sd.items()
        }
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {model_dir}")


def config_from_hf(
    model_dir: str, *, pool: str | None = None, num_labels: int = 0, **overrides: Any
) -> EncoderConfig:
    """:class:`EncoderConfig` from a checkpoint's ``config.json``, read as
    the JAX package reads it: BGE checkpoints pool CLS, others mean; a
    ``*SequenceClassification`` architecture is a cross-encoder."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    if pool is None:
        pool = "cls" if "bge" in str(hf.get("_name_or_path", "")).lower() else "mean"
    archs = hf.get("architectures") or []
    detected_labels = 0
    if any(str(a).endswith("SequenceClassification") for a in archs):
        detected_labels = int(hf.get("num_labels") or len(hf.get("id2label") or {}) or 1)
    cfg = EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["hidden_size"],
        layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        max_len=hf.get("max_position_embeddings", 512),
        type_vocab=hf.get("type_vocab_size", 2),
        ln_eps=hf.get("layer_norm_eps", 1e-12),
        gelu_approx=hf.get("hidden_act", "gelu") in ("gelu_new", "gelu_pytorch_tanh"),
        pool=pool,
        num_labels=num_labels or detected_labels,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _strip_prefix(sd: Mapping[str, np.ndarray]) -> Mapping[str, np.ndarray]:
    """Drop a wrapper prefix (``bert.``, ``model.``, ``roberta.``,
    ``distilbert.``) from the encoder's names."""
    for prefix in ("bert.", "model.", "roberta.", "distilbert."):
        if any(k.startswith(prefix + "embeddings") for k in sd):
            return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    return sd


def convert_bert_checkpoint(sd: Mapping[str, np.ndarray], cfg: EncoderConfig) -> StateDict:
    """HF BERT names -> the ``state_dict`` of ``TextEncoderModel(cfg)``, or
    of ``CrossEncoderModel(cfg)`` when ``cfg.num_labels > 0`` (then the
    ``pooler.dense`` and ``classifier`` weights are read too)."""
    sd = _strip_prefix(sd)
    out: StateDict = {}

    def put(dst: str, src: str) -> None:
        _put(out, dst, sd[src])

    def linear(dst: str, src: str) -> None:
        put(f"{dst}.weight", f"{src}.weight")
        put(f"{dst}.bias", f"{src}.bias")

    put("embeddings.word.weight", "embeddings.word_embeddings.weight")
    put("embeddings.position.weight", "embeddings.position_embeddings.weight")
    if cfg.type_vocab and "embeddings.token_type_embeddings.weight" in sd:
        put("embeddings.token_type.weight", "embeddings.token_type_embeddings.weight")
    linear("embeddings.ln", "embeddings.LayerNorm")
    for i in range(cfg.layers):
        src, dst = f"encoder.layer.{i}", f"layer_{i}"
        for name in ("query", "key", "value"):
            linear(f"{dst}.attention.{name}", f"{src}.attention.self.{name}")
        linear(f"{dst}.attention.out", f"{src}.attention.output.dense")
        linear(f"{dst}.attention_ln", f"{src}.attention.output.LayerNorm")
        linear(f"{dst}.mlp_up", f"{src}.intermediate.dense")
        linear(f"{dst}.mlp_down", f"{src}.output.dense")
        linear(f"{dst}.mlp_ln", f"{src}.output.LayerNorm")
    if cfg.num_labels > 0:
        linear("pooler", "pooler.dense")
        linear("classifier", "classifier")
    return out


def load_encoder(
    model_dir: str,
    *,
    pool: str | None = None,
    num_labels: int = 0,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
    **overrides: Any,
) -> tuple[torch.nn.Module, StateDict, Any]:
    """``(model, state_dict, tokenizer)`` from a local HF checkpoint
    directory: the model on ``device`` with the checkpoint's weights, the
    ``state_dict`` it was given, and a ``WordPieceTokenizer`` over the
    directory's ``vocab.txt`` (None without one)."""
    cfg = config_from_hf(model_dir, pool=pool, num_labels=num_labels, **overrides)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    sd = convert_bert_checkpoint(load_state_dict(model_dir), cfg)
    model = (CrossEncoderModel if cfg.num_labels > 0 else TextEncoderModel)(cfg, device=device)
    model.load_state_dict(sd)
    vocab = os.path.join(model_dir, "vocab.txt")
    tok = WordPieceTokenizer(vocab) if os.path.exists(vocab) else None
    return model, sd, tok
