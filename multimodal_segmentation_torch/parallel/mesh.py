"""A mesh of named axes over the ranks of the default process group, and
the slicing of a global host batch to this rank's part.

Port of multimodal_segmentation_tpu/parallel/mesh.py:19-40. `make_mesh`
builds JAX's ('data', 'model') mesh; the volumetric path builds
Mesh(('data', 'space'), (n_data, n_space)). Ranks fill the mesh in row
order, as make_mesh reshapes jax.devices(). Each axis has its own
process group: the ranks that share every other coordinate.

`batch_sharding` and `replicated` are NamedShardings with no torch
meaning and are not ported: a tensor here lives on one rank, and the
layout is what `shard_batch` slices. The batch is split over 'data' and
replicated over 'model', whose ranks hold slices of the wide parameters
(parallel/sharding.py).
"""

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from multimodal_segmentation_torch.data.prefetch import put_on_device


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its size, this rank's
    index along it, the global ranks along it through this rank (in index
    order) and their process group (None without torch.distributed)."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: object


class Mesh:
    """Named axes over the ranks of the default process group.

    Every rank builds the same mesh (each axis's groups are created in
    the same order on every rank). Without torch.distributed initialised
    only a mesh of one rank can be built, and its axes have no group: the
    collectives over them are skipped. With it, the mesh spans the whole
    world, and even an axis of size 1 has a group, so its collectives run
    (as copies)."""

    def __init__(self, axis_names, shape):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape), strict=True))
        size = math.prod(self.shape.values())
        if dist.is_initialized():
            if dist.get_world_size() != size:
                raise ValueError("a mesh of shape %s needs %d ranks, the process group has %d"
                                 % (self.shape, size, dist.get_world_size()))
            self.rank = dist.get_rank()
        elif size != 1:
            raise ValueError("a mesh of %d ranks needs torch.distributed initialised" % size)
        else:
            self.rank = 0
        dims = tuple(self.shape.values())
        coords = np.unravel_index(self.rank, dims)
        grid = np.arange(size).reshape(dims)
        self._axes = {}
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, dims[i])
            mine = next(tuple(int(r) for r in line) for line in lines if self.rank in line)
            group = None
            if dist.is_initialized():
                # every rank creates every group, in the same order
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        group = g
            self._axes[name] = Axis(name, dims[i], int(coords[i]), mine, group)

    def axis(self, name):
        return self._axes[name]


def make_mesh(n_data=None, n_model=1):
    """A ('data', 'model') mesh over the ranks of the default process
    group (one rank without torch.distributed); n_data defaults to the
    ranks over n_model. Rank r sits at (r // n_model, r % n_model)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        if world % n_model:
            raise ValueError("%d ranks do not split over a 'model' axis of %d" % (world, n_model))
        n_data = world // n_model
    return Mesh(("data", "model"), (n_data, n_model))


def _local_slice(mesh, a, spec):
    """The part of array `a` this rank holds: dimension i split over mesh
    axis spec[i] (None: whole)."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        ax = mesh.axis(name)
        if a.shape[dim] % ax.size:
            raise ValueError("dimension %d of size %d does not split over %d ranks of '%s'"
                             % (dim, a.shape[dim], ax.size, name))
        k = a.shape[dim] // ax.size
        a = a[(slice(None),) * dim + (slice(ax.index * k, (ax.index + 1) * k),)]
    return a


def shard_batch(mesh, batch, device, spec=("data",)):
    """This rank's slice of a global host batch, as f32 tensors on
    `device`; only the slice is copied. `batch` is an array or a nested
    dict, list or tuple of arrays; dimension i of each is split over mesh
    axis spec[i] (None: kept whole), the batch axis over 'data' by
    default, and (spec ('data', 'space')) a volume's depth over 'space'.
    Every rank gets the same number of rows."""
    def local(b):
        if isinstance(b, dict):
            return {k: local(v) for k, v in b.items()}
        if isinstance(b, (list, tuple)):
            return type(b)(local(v) for v in b)
        return _local_slice(mesh, b, spec)

    return put_on_device(local(batch), torch.device(device))
