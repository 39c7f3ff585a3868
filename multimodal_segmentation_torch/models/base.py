"""Helpers shared by the models' training losses.

Port of multimodal_segmentation_tpu/models/base.py:122-167.
"""

import torch


def add_residual(masks):
    """Append a background channel = 1 - union of the mask channels to an
    NHWC (B, H, W, num_masks) {0,1} mask batch
    (model_executors/base_executor.py:83-87)."""
    hit = (masks == 1.0).to(masks.dtype)
    residual = 1.0 - torch.amax(hit, dim=-1, keepdim=True)
    return torch.cat([masks, residual], dim=-1)


def subsample_pool(slot_idx, variants):
    """Fake-pool subsample as a per-slot select (models/base.py:132-167):
    slot b of the result is variants[slot_idx[b]][b].

    Args:
      slot_idx: (B,) integer tensor with values in [0, len(variants)); the
        caller draws it (the JAX package draws jax.random.randint).
      variants: list of K equally-shaped (B, ...) tensors.
    """
    if len(variants) == 1:
        return variants[0]
    shape = (slot_idx.shape[0],) + (1,) * (variants[0].dim() - 1)
    idx = slot_idx.to(variants[0].device).reshape(shape)
    out = variants[0]
    for j in range(1, len(variants)):
        out = torch.where(idx == j, variants[j], out)
    return out
