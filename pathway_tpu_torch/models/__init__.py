"""The port's encoders (counterpart of ``pathway_tpu/models``): the
BERT-family :class:`TextEncoderModel` and :class:`CrossEncoderModel`, the
SigLIP-class :class:`VisionEncoderModel` / :class:`DualEncoderModel`,
their presets, the hash, WordPiece and HuggingFace tokenizers, the flax
-> torch weight bridge and the HF checkpoint loader."""

from pathway_tpu_torch.models.convert import (
    config_from_hf,
    convert_bert_checkpoint,
    dual_state_dict_from_flax,
    load_encoder,
    load_state_dict,
    state_dict_from_flax,
    vision_state_dict_from_flax,
)
from pathway_tpu_torch.models.encoder import (
    BGE_BASE,
    BGE_LARGE,
    BGE_RERANKER_BASE,
    BGE_SMALL,
    E5_BASE,
    MINILM_L6,
    CrossEncoderModel,
    EncoderConfig,
    TextEncoderModel,
    encoder_param_specs,
)
from pathway_tpu_torch.models.tokenizer import HashTokenizer, HFTokenizer, Tokenizer, get_tokenizer
from pathway_tpu_torch.models.vision import (
    SIGLIP_BASE,
    DualEncoderModel,
    VisionConfig,
    VisionEncoderModel,
)
from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer, load_vocab

__all__ = [
    "EncoderConfig",
    "TextEncoderModel",
    "CrossEncoderModel",
    "encoder_param_specs",
    "VisionConfig",
    "VisionEncoderModel",
    "DualEncoderModel",
    "MINILM_L6",
    "BGE_SMALL",
    "BGE_BASE",
    "BGE_LARGE",
    "E5_BASE",
    "BGE_RERANKER_BASE",
    "SIGLIP_BASE",
    "Tokenizer",
    "HashTokenizer",
    "HFTokenizer",
    "WordPieceTokenizer",
    "load_vocab",
    "get_tokenizer",
    "state_dict_from_flax",
    "vision_state_dict_from_flax",
    "dual_state_dict_from_flax",
    "load_state_dict",
    "config_from_hf",
    "convert_bert_checkpoint",
    "load_encoder",
]
