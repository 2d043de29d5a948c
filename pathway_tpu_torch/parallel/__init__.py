"""The port's device plane on one card: the batched encoder executor and
the device-resident KNN index (counterpart of ``pathway_tpu/parallel``;
meshes and the IVF index come in later slices)."""

from pathway_tpu_torch.parallel.executor import TorchEncoder
from pathway_tpu_torch.parallel.sharded_knn import ShardedKnnIndex

__all__ = ["TorchEncoder", "ShardedKnnIndex"]
