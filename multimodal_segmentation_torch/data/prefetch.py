"""Device prefetch: overlap the host's batch assembly and the host-to-device
copy with the device's compute.

Port of multimodal_segmentation_tpu/data/prefetch.py:16-38. The iterator
keeps DEPTH batches ahead as tensors on `device`. On a GPU each array is
copied into pinned host memory and sent with non_blocking=True, so the copy
runs on the stream while the host goes on; PyTorch's pinned-memory
allocator keeps the host buffer until the copy is done. Under a mesh
(parallel/mesh.py) every rank reads the same global batches and puts only
its slice on its device (`shard_batch`).
"""

import collections

import numpy as np
import torch

DEPTH = 2


def put_on_device(batch, device):
    """An array, or a nested dict, list or tuple of them -> the same
    structure of f32 tensors on `device`."""
    if isinstance(batch, dict):
        return {k: put_on_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(put_on_device(v, device) for v in batch)
    if torch.is_tensor(batch):
        return batch.to(device, torch.float32)
    t = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator, device="cpu", mesh=None):
    """Wrap an iterator of (nested) dicts of arrays, keeping DEPTH of them
    on `device` ahead of consumption; under `mesh`, this rank's slice of
    each (the batch axis split over 'data')."""
    from multimodal_segmentation_torch.parallel.mesh import shard_batch

    device = torch.device(device)
    queue = collections.deque()
    for batch in iterator:
        queue.append(put_on_device(batch, device) if mesh is None
                     else shard_batch(mesh, batch, device))
        if len(queue) < DEPTH:
            continue
        yield queue.popleft()
    while queue:
        yield queue.popleft()
