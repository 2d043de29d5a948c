"""The port's hand-written CUDA kernels for Hopper (``sm_90a``).

=================  ============================  =================================
kernel             source                        replaces (JAX program)
=================  ============================  =================================
K1 attention       ``csrc/attention.cu``         ``models/encoder.py:113-117``
K2 slab            ``csrc/slab_scatter.cu``      ``parallel/sharded_knn.py:123-176``
K3 knn_topk        ``csrc/knn_topk.cu``          ``parallel/sharded_knn.py:336-341``
K4 bias_act        ``csrc/bias_act.cu``          ``models/encoder.py:88-150,222-224``,
                                                 ``models/vision.py:60-76``
K5 add_layer_norm  ``csrc/add_layer_norm.cu``    ``models/encoder.py:128-150``
K6 embed_ln        ``csrc/embed_ln.cu``          ``models/encoder.py:152-176``
K7 pool_normalize  ``csrc/pool_normalize.cu``    ``models/encoder.py:196-202``; the
    pool_normalize_                              ingest tail also K2's scatter
    into                                         (``parallel/sharded_knn.py:166-176``)
K8 patchify        ``csrc/patchify.cu``          ``models/vision.py:60-69``
K9 vision_head     ``csrc/vision_head.cu``       ``models/vision.py:81-87``
K10 dual_logits    ``csrc/dual_logits.cu``       ``models/vision.py:120``
K11 ivf_assign     ``csrc/ivf_assign.cu``        ``parallel/ivf_knn.py:44-47,62-66``
K12 ivf_scan       ``csrc/ivf_scan.cu``          ``parallel/ivf_knn.py:318-339``
K13 topk_select    ``csrc/topk_select.cu``       ``jax.lax.top_k`` for k > 128 in
                                                 ``parallel/sharded_knn.py:336-375``,
                                                 ``parallel/ivf_knn.py:320-336``
K14 ring_block     ``csrc/ring_block.cu``        ``ops/ring_attention.py:47-77``
K15 attention_bwd  ``csrc/attention_bwd.cu``     B1's transpose in the train step
                                                 (``__graft_entry__.py:117-131``)
K16 bias_act_bwd   ``csrc/bias_act_bwd.cu``      B2's bias and GELU transposes
K17 layer_norm_bwd ``csrc/layer_norm_bwd.cu``    B2's and B3's LayerNorm transposes
    embed_ln_bwd                                 (with B3's table scatter-adds)
K18 contrastive_   ``csrc/contrastive_loss.cu``  ``loss_fn`` (``__graft_entry__.py:
    loss, _bwd,                                  117-124``) with both of its
    pool_normalize_bwd                           products, and B4's transpose
K19 adam           ``csrc/adam.cu``              ``optax.adam`` + ``apply_updates``
                                                 (``__graft_entry__.py:126-131``)
B8 cross_head      ``csrc/cross_head.cu``        ``models/encoder.py:222-231``
=================  ============================  =================================

Each wrapper checks device, dtype, shape and contiguity, launches its
kernel on PyTorch's current stream for CUDA tensors and counts each
kernel launch in its ``launches`` attribute (``knn_topk`` launches pass 1
and its merge passes, one count each, and before the tensor-core pass the
split of its queries; ``ivf_scan``'s merge passes are
K3's and count on ``knn_topk``; a selection above ``MAX_K`` counts its
score-only pass on ``knn_topk`` or ``ivf_scan`` and its select on
``topk_select``); for CPU tensors it runs the plain
PyTorch version beside it.  Kernels build from ``csrc/`` at first use
(:mod:`pathway_tpu_torch.kernels._build`).  The cross-encoder's head
(B8: pooler, tanh, classifier) is one launch of ``cross_head`` outside
training, where K4 with tanh ran between cuBLAS products before.  K1 and K4-K7 have autograd
Functions (``AttentionFunction``, ``BiasActFunction``,
``AddLayerNormFunction``, ``EmbedLnFunction``, ``PoolNormalizeFunction``)
whose backward is K15-K17 and K18's pool backward; the train step
(:mod:`pathway_tpu_torch.train`) adds K18's loss (``contrastive_loss``
and ``contrastive_loss_bwd``, one launch each) and K19.
"""

from pathway_tpu_torch.kernels.adam import adam_step, adam_step_plain
from pathway_tpu_torch.kernels.add_layer_norm import (
    add_layer_norm,
    add_layer_norm_plain,
    layer_norm_bwd,
    layer_norm_bwd_plain,
)
from pathway_tpu_torch.kernels.attention import attention, attention_bwd, attention_bwd_plain, attention_plain
from pathway_tpu_torch.kernels.bias_act import bias_act, bias_act_bwd, bias_act_bwd_plain, bias_act_plain
from pathway_tpu_torch.kernels.contrastive_loss import (
    contrastive_loss,
    contrastive_loss_bwd,
    contrastive_loss_bwd_plain,
    contrastive_loss_fwd_plain,
    contrastive_loss_plain,
)
from pathway_tpu_torch.kernels.cross_head import cross_head, cross_head_plain
from pathway_tpu_torch.kernels.dual_logits import dual_logits, dual_logits_plain
from pathway_tpu_torch.kernels.embed_ln import embed_ln, embed_ln_bwd, embed_ln_bwd_plain, embed_ln_plain
from pathway_tpu_torch.kernels.ivf_assign import ivf_assign, ivf_assign_plain
from pathway_tpu_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
from pathway_tpu_torch.kernels.knn_topk import MAX_K, knn_topk, knn_topk_plain
from pathway_tpu_torch.kernels.patchify import patch_grid, patchify, patchify_plain
from pathway_tpu_torch.kernels.pool_normalize import (
    pool_normalize,
    pool_normalize_bwd,
    pool_normalize_bwd_plain,
    pool_normalize_into,
    pool_normalize_into_plain,
    pool_normalize_plain,
)
from pathway_tpu_torch.kernels.ring_block import ring_block, ring_block_plain, ring_state
from pathway_tpu_torch.kernels.slab_scatter import (
    slab_clear,
    slab_clear_plain,
    slab_scatter,
    slab_scatter_plain,
)
from pathway_tpu_torch.kernels.topk_select import topk_select, topk_select_plain
from pathway_tpu_torch.kernels.vision_head import vision_head, vision_head_plain

__all__ = [
    "attention",
    "attention_plain",
    "slab_scatter",
    "slab_scatter_plain",
    "slab_clear",
    "slab_clear_plain",
    "knn_topk",
    "knn_topk_plain",
    "MAX_K",
    "bias_act",
    "bias_act_plain",
    "add_layer_norm",
    "add_layer_norm_plain",
    "embed_ln",
    "embed_ln_plain",
    "pool_normalize",
    "pool_normalize_plain",
    "pool_normalize_into",
    "pool_normalize_into_plain",
    "patchify",
    "patchify_plain",
    "patch_grid",
    "vision_head",
    "vision_head_plain",
    "dual_logits",
    "dual_logits_plain",
    "ivf_assign",
    "ivf_assign_plain",
    "ivf_scan",
    "ivf_scan_plain",
    "topk_select",
    "topk_select_plain",
    "ring_block",
    "ring_block_plain",
    "ring_state",
    "attention_bwd",
    "attention_bwd_plain",
    "bias_act_bwd",
    "bias_act_bwd_plain",
    "layer_norm_bwd",
    "layer_norm_bwd_plain",
    "embed_ln_bwd",
    "embed_ln_bwd_plain",
    "contrastive_loss",
    "contrastive_loss_plain",
    "contrastive_loss_fwd_plain",
    "contrastive_loss_bwd",
    "contrastive_loss_bwd_plain",
    "cross_head",
    "cross_head_plain",
    "pool_normalize_bwd",
    "pool_normalize_bwd_plain",
    "adam_step",
    "adam_step_plain",
    "WRAPPERS",
    "launch_counts",
    "reset_launch_counts",
]

#: every kernel wrapper, by the name its launch count is reported under
WRAPPERS = {
    "attention": attention,
    "slab_scatter": slab_scatter,
    "slab_clear": slab_clear,
    "knn_topk": knn_topk,
    "bias_act": bias_act,
    "add_layer_norm": add_layer_norm,
    "embed_ln": embed_ln,
    "pool_normalize": pool_normalize,
    "pool_normalize_into": pool_normalize_into,
    "patchify": patchify,
    "vision_head": vision_head,
    "dual_logits": dual_logits,
    "ivf_assign": ivf_assign,
    "ivf_scan": ivf_scan,
    "topk_select": topk_select,
    "ring_block": ring_block,
    "attention_bwd": attention_bwd,
    "bias_act_bwd": bias_act_bwd,
    "layer_norm_bwd": layer_norm_bwd,
    "embed_ln_bwd": embed_ln_bwd,
    "contrastive_loss": contrastive_loss,
    "contrastive_loss_bwd": contrastive_loss_bwd,
    "pool_normalize_bwd": pool_normalize_bwd,
    "adam": adam_step,
    "cross_head": cross_head,
}


def launch_counts() -> dict[str, int]:
    """CUDA kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
