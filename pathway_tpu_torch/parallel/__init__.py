"""The port's device plane on one card: the batched encoder executor,
the device-resident brute-force KNN index and the IVF approximate index
(counterpart of ``pathway_tpu/parallel``; meshes come in a later slice)."""

from pathway_tpu_torch.parallel.executor import TorchEncoder
from pathway_tpu_torch.parallel.ivf_knn import IvfKnnIndex
from pathway_tpu_torch.parallel.sharded_knn import ShardedKnnIndex

__all__ = ["TorchEncoder", "ShardedKnnIndex", "IvfKnnIndex"]
