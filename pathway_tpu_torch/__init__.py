"""``pathway_tpu_torch``: the PyTorch/CUDA port of ``pathway_tpu``'s
device plane, for one NVIDIA H100 (``sm_90a``).

It carries the live-RAG paths: text -> hash or WordPiece tokenizer ->
BERT-family encoder (:mod:`~pathway_tpu_torch.models`; seeded weights or
a local HF checkpoint), data parallel over a device mesh or not ->
device-resident KNN index (:mod:`~pathway_tpu_torch.parallel`, brute
force on one card or sharded over the mesh, or the IVF approximate
index), retrieve -> cross-encoder rerank
(:mod:`~pathway_tpu_torch.xpacks.llm.rerankers`), and images -> SigLIP-class
dual encoder -> index -> text-to-image retrieve, with hand-written CUDA
kernels for the attention core, the dense layers' bias/activation
epilogue (and the patch embed's position add), residual + LayerNorm, the
embedding gather + LayerNorm, pooling + normalize, the patchify, the
vision tail, the pairwise logits, the slab scatter, the fused score +
top-k, the IVF's centroid assignment and its cell scan, and the radix
top-k select for k above 128 (:mod:`~pathway_tpu_torch.kernels`).  The package imports torch
and numpy, never jax or ``pathway_tpu``.  Entry points run on
``device="cuda"`` unless the caller passes another device, and raise
when no card is present.
"""

from pathway_tpu_torch import kernels, models, ops, parallel
from pathway_tpu_torch.models import (
    BGE_BASE,
    BGE_RERANKER_BASE,
    SIGLIP_BASE,
    CrossEncoderModel,
    DualEncoderModel,
    EncoderConfig,
    TextEncoderModel,
    VisionConfig,
    VisionEncoderModel,
)
from pathway_tpu_torch.parallel import (
    IvfKnnIndex,
    ShardedKnnIndex,
    TorchEncoder,
    best_mesh,
    make_mesh,
    mesh_axis_size,
)
from pathway_tpu_torch.xpacks.llm.embedders import (
    SentenceTransformerEmbedder,
    TorchEncoderEmbedder,
)
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    rerank_topk_filter,
)

__all__ = [
    "kernels",
    "models",
    "ops",
    "parallel",
    "EncoderConfig",
    "TextEncoderModel",
    "CrossEncoderModel",
    "VisionConfig",
    "VisionEncoderModel",
    "DualEncoderModel",
    "BGE_BASE",
    "BGE_RERANKER_BASE",
    "SIGLIP_BASE",
    "TorchEncoder",
    "ShardedKnnIndex",
    "IvfKnnIndex",
    "make_mesh",
    "best_mesh",
    "mesh_axis_size",
    "TorchEncoderEmbedder",
    "SentenceTransformerEmbedder",
    "CrossEncoderReranker",
    "EncoderReranker",
    "rerank_topk_filter",
]
