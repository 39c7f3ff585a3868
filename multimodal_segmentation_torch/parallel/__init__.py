"""Data and tensor parallelism over torch.distributed process groups: the
process start (distributed.py), the named-axis mesh and its batch slicing
(mesh.py), the differentiable collectives (collectives.py), the spatially
sharded convolutions with their halo exchange (halo.py) and the sharding
of wide parameters over 'model' (sharding.py).

Port of multimodal_segmentation_tpu/parallel/{distributed,mesh,halo,
sharding}.py.
GSPMD gives the JAX package global-batch statistics and gradient
reductions for free; here every batch-wide sum is all-reduced by hand,
through collectives whose backward reduces the gradient in turn.
"""

from multimodal_segmentation_torch.parallel.collectives import (
    all_reduce_flat_,
    all_reduce_sum,
    mean_over,
)
from multimodal_segmentation_torch.parallel.distributed import (
    barrier,
    is_writer,
    local_device,
    maybe_initialize_distributed,
)
from multimodal_segmentation_torch.parallel.halo import halo_conv2d, halo_conv3d
from multimodal_segmentation_torch.parallel.mesh import Axis, Mesh, make_mesh, shard_batch
from multimodal_segmentation_torch.parallel.sharding import (
    count_sharded_leaves,
    tp_shard_train_state,
)

__all__ = ["Axis", "Mesh", "all_reduce_flat_", "all_reduce_sum", "barrier",
           "count_sharded_leaves", "halo_conv2d", "halo_conv3d", "is_writer", "local_device",
           "make_mesh", "maybe_initialize_distributed", "mean_over", "shard_batch",
           "tp_shard_train_state"]
