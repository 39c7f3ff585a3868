"""Rotation augmentation on the device.

Port of multimodal_segmentation_tpu/ops/augment.py:20-157 (reference
model_executors/base_executor.py:37-78: keras ImageDataGenerator with
rotation_range=20, one shared transform for the images and masks of both
modalities). Nearest-neighbour resampling with edge-clamp fill, rounding
half to even. Arrays are NHWC (B, H, W, C), as in the JAX package.

`rotate_batch` dispatches by device: the nearest-warp CUDA kernel
(ops/cuda_kernels.py::nearest_warp) for a tensor on the GPU, the plain
gather (`_nearest_warp_plain`) for a tensor on the CPU. Both sample at the
locations of `rotation_locations`, so they agree bit for bit.
"""

import math

import torch

from multimodal_segmentation_torch.ops.cuda_kernels import nearest_warp


def random_rotation_angles(generator, batch, rotation_range_deg=20.0):
    """Uniform angles in [-range, range) degrees, returned in radians, drawn
    from `generator` on its device."""
    u = torch.rand(batch, generator=generator, device=generator.device)
    deg = u * (2.0 * rotation_range_deg) - rotation_range_deg
    return deg * (math.pi / 180.0)


def rotation_locations(thetas, H, W):
    """Per-sample pixel-space source locations for a rotation about the
    image centre: (B, H*W, 2) f32 (y, x), the inverse-mapped source of
    every destination pixel, source = R(-theta) (dest - c) + c. The same
    f32 operations in the same order as the JAX package (ops/augment.py:
    52-71), so the locations, and the ties that round half to even, agree.
    """
    dev = thetas.device
    cy = (H - 1) / 2.0
    cx = (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    dy = (ys - cy).expand(H, W)
    dx = (xs - cx).expand(H, W)
    th = thetas.float()
    cos_t = torch.cos(th)[:, None, None]
    sin_t = torch.sin(th)[:, None, None]
    src_y = cos_t * dy[None] - sin_t * dx[None] + cy
    src_x = sin_t * dy[None] + cos_t * dx[None] + cx
    B = thetas.shape[0]
    return torch.stack([src_y.reshape(B, H * W), src_x.reshape(B, H * W)], dim=-1)


def _nearest_warp_plain(vol, locs):
    """Plain PyTorch version of the nearest warp (kernel nearest_warp): the
    gather of the JAX package's _rotate_one at explicit locations."""
    B, H, W, C = vol.shape
    yi = torch.clamp(torch.round(locs[..., 0]), 0, H - 1).long()
    xi = torch.clamp(torch.round(locs[..., 1]), 0, W - 1).long()
    idx = (yi * W + xi).unsqueeze(-1).expand(-1, -1, C)
    return torch.gather(vol.reshape(B, H * W, C), 1, idx).reshape(vol.shape)


def rotate_batch(batch_imgs, thetas):
    """Rotate a (B, H, W, C) batch by per-sample angles (radians, a (B,)
    tensor on the same device). Not differentiable."""
    B, H, W, C = batch_imgs.shape
    locs = rotation_locations(thetas, H, W)
    if batch_imgs.device.type == "cuda":
        return nearest_warp(batch_imgs.contiguous(), locs)
    if batch_imgs.device.type != "cpu":
        raise ValueError("rotate_batch runs on 'cuda' or 'cpu', got %s" % batch_imgs.device)
    return _nearest_warp_plain(batch_imgs, locs)


def random_rotate_batch(arrays, thetas):
    """Rotate every (B, H, W, C_i) array in `arrays` by the same per-sample
    angles `thetas` (B,): the arrays are concatenated along channels and
    rotated in one call, then split again (ops/augment.py:132-157)."""
    if not arrays:
        return arrays
    widths = [a.shape[-1] for a in arrays]
    out = rotate_batch(torch.cat(arrays, dim=-1), thetas)
    return list(torch.split(out, widths, dim=-1))
