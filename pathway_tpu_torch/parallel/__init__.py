"""The port's device plane: the batched encoder executor, the
device-resident brute-force KNN index (on one card or sharded over a
mesh), the IVF approximate index and the device mesh (counterpart of
``pathway_tpu/parallel``)."""

from pathway_tpu_torch.parallel.executor import TorchEncoder
from pathway_tpu_torch.parallel.ivf_knn import IvfKnnIndex
from pathway_tpu_torch.parallel.mesh import Mesh, best_mesh, make_mesh, mesh_axis_size
from pathway_tpu_torch.parallel.sharded_knn import ShardedKnnIndex

__all__ = [
    "TorchEncoder",
    "ShardedKnnIndex",
    "IvfKnnIndex",
    "Mesh",
    "make_mesh",
    "best_mesh",
    "mesh_axis_size",
]
