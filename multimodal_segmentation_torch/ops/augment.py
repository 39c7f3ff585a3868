"""Rotation and brightness/contrast augmentation on the device.

Port of multimodal_segmentation_tpu/ops/augment.py:20-157 (reference
model_executors/base_executor.py:37-78: keras ImageDataGenerator with
rotation_range=20, one shared transform for the images and masks of both
modalities). Nearest-neighbour resampling with edge-clamp fill, rounding
half to even. Arrays are NHWC (B, H, W, C), as in the JAX package.

`random_rotate_batch` dispatches by device. On the GPU one launch of the
nearest-warp kernel rotates a whole group (ops/cuda_kernels.py::
rotate_group): it reads each array and writes each output directly, with
no concatenation and no split, and computes each location itself from the
per-sample cos/sin, in the f32 operation order of `rotation_locations`
(its plain version is `_rotate_group_plain`). On the CPU the group is
concatenated, sampled at `rotation_locations` by the plain gather
(`_nearest_warp_plain`) and split, as the JAX package does.
`rotate_batch` (one array) samples at `rotation_locations` with the
nearest_warp kernel on the GPU and the plain gather on the CPU; the
volumetric path's `random_rotate_volumes` calls it twice a step (volumes
and masks). All of them agree bit for bit.
"""

import math

import torch

from multimodal_segmentation_torch.ops.cuda_kernels import MAX_GROUP, nearest_warp, rotate_group


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


def _rotate_group_plain(arrays, cos_t, sin_t):
    """Plain PyTorch version of the fused group rotation (kernel
    rotate_group): the locations of `rotation_locations` from the given
    cos/sin, the same f32 operations in the same order, then the gather of
    `_nearest_warp_plain` on each array."""
    B, H, W, _ = arrays[0].shape
    dev = arrays[0].device
    cy = (H - 1) / 2.0
    cx = (W - 1) / 2.0
    dy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy
    dx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx
    c = cos_t[:, None, None]
    s = sin_t[:, None, None]
    yi = torch.clamp(torch.round(c * dy - s * dx + cy), 0, H - 1).long()
    xi = torch.clamp(torch.round(s * dy + c * dx + cx), 0, W - 1).long()
    idx = (yi * W + xi).reshape(B, H * W, 1)
    return [torch.gather(a.reshape(B, H * W, a.shape[-1]), 1, idx.expand(-1, -1, a.shape[-1]))
            .reshape(a.shape) for a in arrays]


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
    angles `thetas` (B,), as the JAX package's random_rotate_batch
    (ops/augment.py:132-157) does by concatenating along channels, rotating
    once and splitting. On the GPU: one rotate_group launch per MAX_GROUP
    arrays, no concatenation. Not differentiable."""
    if not arrays:
        return arrays
    if arrays[0].device.type == "cuda":
        th = thetas.float()
        cos_t, sin_t = torch.cos(th), torch.sin(th)
        return [out for k in range(0, len(arrays), MAX_GROUP)
                for out in rotate_group([a.contiguous() for a in arrays[k:k + MAX_GROUP]],
                                        cos_t, sin_t)]
    widths = [a.shape[-1] for a in arrays]
    out = rotate_batch(torch.cat(arrays, dim=-1), thetas)
    return list(torch.split(out, widths, dim=-1))


def random_rotate_volumes(thetas, volumes, masks):
    """In-plane rotation of (B, D, H, W, C) volumes and their masks about
    the slice axis (ops/augment.py:160-177): one angle per study (thetas,
    (B,) radians, e.g. from random_rotation_angles), shared by its D
    slices and its masks. As in the JAX package, the volumes and the masks
    each go through rotate_batch on (B*D, H, W, C): one nearest_warp
    launch each on the GPU. Not differentiable. On a ('data', 'space')
    mesh it takes a rank's part, (B_local, D_local, ...), with the angles
    of its studies: each D-slab turns by its study's angle, and the
    kernel sees (B_local * D_local, H, W, C)."""
    B, D = volumes.shape[0], volumes.shape[1]
    th = thetas.repeat_interleave(D)

    def rot(x):
        flat = x.reshape((B * D,) + tuple(x.shape[2:]))
        return rotate_batch(flat, th.to(x.dtype)).reshape(x.shape)

    return rot(volumes), rot(masks)


def random_brightness_contrast(generator, images, brightness=0.2, contrast=0.2):
    """Per-sample brightness/contrast jitter (ops/augment.py:117-129;
    reference utils/image_utils.py:100-110): x' = x * (1 + c) + b with
    b ~ U(-brightness, brightness), c ~ U(-contrast, contrast), drawn from
    `generator` (on the images' device). images: (B, H, W, C)."""
    shape = (images.shape[0], 1, 1, 1)
    dev = images.device

    def uniform(bound):
        u = torch.rand(shape, generator=generator, device=dev)
        return u * (2.0 * bound) - bound

    b = uniform(brightness)
    c = uniform(contrast)
    return images * (1.0 + c) + b
