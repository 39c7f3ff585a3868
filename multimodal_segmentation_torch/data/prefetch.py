"""Device prefetch: overlap the host's batch assembly and the host-to-device
copy with the device's compute.

Port of multimodal_segmentation_tpu/data/prefetch.py:16-38. The iterator
keeps DEPTH batches ahead as tensors on `device`. On a GPU each array is
copied into pinned host memory and sent with non_blocking=True, so the copy
runs on the stream while the host goes on; PyTorch's pinned-memory
allocator keeps the host buffer until the copy is done.
"""

import collections

import numpy as np
import torch

DEPTH = 2


def _put(batch, device):
    """A nested dict of numpy arrays -> the same dict of f32 tensors on
    `device`."""
    if isinstance(batch, dict):
        return {k: _put(v, device) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator, device="cpu"):
    """Wrap an iterator of (nested) dicts of arrays, keeping DEPTH of them
    on `device` ahead of consumption."""
    device = torch.device(device)
    queue = collections.deque()
    for batch in iterator:
        queue.append(_put(batch, device))
        if len(queue) < DEPTH:
            continue
        yield queue.popleft()
    while queue:
        yield queue.popleft()
