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

It also carries the host plane's engine core, the Pathway Table API
(``Table``, ``this``, ``reducers``, ``udf``/``UDF``, ``Schema``, ``G``,
``debug``, ...) over the epoch scheduler and the package's own C++
extension (``pathway_torch_native``), so that a pipeline can drive the
device plane, as ``TorchEncoderEmbedder`` does as a UDF::

    import pathway_tpu_torch as pw

    t = pw.debug.table_from_markdown("word | n\n a | 1\n b | 2")
    pw.debug.compute_and_print(t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.n)))

The live retrieval indexes come with it (``pw.indexing``, also
``pw.stdlib.indexing``: ``DataIndex`` over the card-resident KNN and IVF
indexes, BM25 and hybrid RRF, behind ``SegmentedIndex``'s delta segment
and background merge), and the rerankers are UDFs.  :func:`run` runs a
pipeline with the file, Python and REST connectors (``pw.io``), and
``pw.xpacks.llm`` serves it: ``DocumentStore``, ``VectorStoreServer`` and
question answering over REST.  :func:`run` analyses the graph before it
runs it and executes the plan compiler's rewrite of it (``pw.analysis``:
``analyze``, ``explain``, ``estimate_memory``, ``strict``; the columnar
fast paths at ``optimize=2``).  The rest of the host plane comes in later
slices (ROADMAP queue A): a name that belongs to one (``persistence``,
``iterate``, ``sql``, the stdlib beyond indexing and utils, the other
connectors, ...) raises an ``AttributeError`` that names its item, and
:func:`run` raises ``NotImplementedError`` for what needs one
(persistence, the monitoring server).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import api as _api
from pathway_tpu_torch.internals import dtype as _dt
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.api import PENDING, PyObjectWrapper, wrap_py_object
from pathway_tpu_torch.internals.config import set_license_key, set_monitoring_config
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_with_type,
    cast,
    coalesce,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals.joins import JoinKind, JoinMode, JoinResult
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.internals.parse_graph import G, global_error_log
from pathway_tpu_torch.internals.row_transformer import (
    ClassArg,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.internals.run import MonitoringLevel, run, run_all
from pathway_tpu_torch.internals.schema import (
    Schema,
    column_definition,
    schema_builder,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals.udfs import UDF, udf

from pathway_tpu_torch import debug, reducers
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

#: engine Error value — poisoned cells propagate instead of aborting
Error = _api.ERROR

DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
DATE_TIME_UTC = _dt.DATE_TIME_UTC
DURATION = _dt.DURATION

#: names of ``pathway_tpu`` that later slices of the port bring, by the
#: ROADMAP item that brings them
_LATER = {
    **dict.fromkeys(
        ("persistence", "PersistenceMode", "testing"),
        "item 16 (slice 16c: persistence and the chaos drills)",
    ),
    **dict.fromkeys(
        ("demo", "universes", "iterate", "iterate_universe", "enable_interactive_mode", "LiveTable",
         "live", "export_table", "import_table", "ExportedTable", "sql", "load_yaml"),
        "item 16 (slice 16d: the rest of internals)",
    ),
    **dict.fromkeys(
        ("temporal", "ml", "graphs", "stateful", "statistical", "ordered", "viz"),
        "item 16 (slice 16d: stdlib beyond indexing)",
    ),
}


def __getattr__(name: str) -> Any:
    # heavier subpackages load lazily to keep import fast
    if name == "io":
        import pathway_tpu_torch.io as io

        return io
    if name == "utils":
        import pathway_tpu_torch.stdlib.utils as utils

        return utils
    if name == "AsyncTransformer":
        from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer

        return AsyncTransformer
    if name == "xpacks":
        import pathway_tpu_torch.xpacks as xpacks

        return xpacks
    if name == "stdlib":
        import pathway_tpu_torch.stdlib as stdlib

        return stdlib
    if name == "indexing":
        import pathway_tpu_torch.stdlib.indexing as indexing

        return indexing
    if name == "asynchronous":
        # deprecated alias kept for parity (reference pathway.asynchronous -> pw.udfs)
        return udfs
    if name in ("DateTimeNaive", "DateTimeUtc", "Duration"):
        return getattr(_dt, name)
    if name == "declare_type":
        from pathway_tpu_torch.internals.expression import declare_type

        return declare_type
    if name == "ConnectorRecoveryPolicy":
        from pathway_tpu_torch.internals.resilience import ConnectorRecoveryPolicy

        return ConnectorRecoveryPolicy
    if name == "attach_prober":
        from pathway_tpu_torch.internals.run import attach_prober

        return attach_prober
    if name == "analysis":
        import pathway_tpu_torch.analysis as analysis

        return analysis
    if name in (
        "analyze",
        "explain",
        "estimate_memory",
        "MemoryReport",
        "EstimateParams",
        "Diagnostic",
        "AnalysisError",
        "ExecutionPlan",
    ):
        from pathway_tpu_torch import analysis

        return getattr(analysis, name)
    if name in _LATER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} yet: the port brings it with "
            f"ROADMAP {_LATER[name]}"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Table",
    "Schema",
    "Json",
    "Pointer",
    "Error",
    "PENDING",
    "PyObjectWrapper",
    "wrap_py_object",
    "ColumnExpression",
    "ColumnReference",
    "this",
    "left",
    "right",
    "JoinKind",
    "JoinMode",
    "JoinResult",
    "apply",
    "apply_async",
    "apply_with_type",
    "cast",
    "coalesce",
    "if_else",
    "require",
    "unwrap",
    "fill_error",
    "make_tuple",
    "udf",
    "udfs",
    "UDF",
    "run",
    "run_all",
    "global_error_log",
    "ClassArg",
    "input_attribute",
    "input_method",
    "method",
    "output_attribute",
    "transformer",
    "MonitoringLevel",
    "debug",
    "reducers",
    "column_definition",
    "schema_from_types",
    "schema_from_dict",
    "schema_builder",
    "schema_from_pandas",
    "set_license_key",
    "set_monitoring_config",
    "G",
    "analyze",
    "explain",
    "estimate_memory",
    "MemoryReport",
    "EstimateParams",
    "Diagnostic",
    "AnalysisError",
    "ExecutionPlan",
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
