"""Engine: epoch-synchronous incremental dataflow (host plane).

TPU-build equivalent of the reference Rust engine (``src/engine/``): update
streams, operator nodes, scheduler, reducers.  The numeric plane (embedders,
KNN, rerankers) lives in ``pathway_tpu_torch.ops`` / ``pathway_tpu_torch.models`` and is
fed micro-batches by this engine.
"""

from pathway_tpu_torch.engine.graph import EngineGraph, Node, RunContext
from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.engine.stream import Batch, Update

__all__ = ["EngineGraph", "Node", "RunContext", "Scheduler", "Batch", "Update"]
