"""Spatially sharded convolution with a halo exchange.

Port of multimodal_segmentation_tpu/parallel/halo.py:49-108: the input is
split over a mesh axis along one spatial dimension (H of an NHWC image,
D of an NDHWC volume); each shard brings in k//2 edge slabs of each
neighbour (zeros at the global edges: SAME zero padding), then runs the
convolution VALID along that dimension and SAME along the others. The
result equals the unsharded SAME convolution up to the order of the
sums. Odd kernels only, as in the JAX package. The exchange is
differentiable (parallel/collectives.py::exchange_halos).

The weights are in torch's layout, (C_out, C_in, k...). `sharded_conv`
is the channels-first form the 3-D UNet's Conv3d calls.
"""

import torch.nn.functional as F

from multimodal_segmentation_torch.parallel.collectives import exchange_halos


def sharded_conv(x, weight, bias, axis, transport=None):
    """SAME conv2d or conv3d (by weight.dim()) of channels-first `x`
    whose dimension 2 (H, or D) is split over mesh `axis`; stride 1, odd
    kernels."""
    ks = weight.shape[2:]
    if any(k % 2 == 0 for k in ks):
        raise ValueError("odd kernels only, got %s" % (tuple(ks),))
    xp = exchange_halos(x, ks[0] // 2, 2, axis, transport)
    pad = (0,) + tuple(k // 2 for k in ks[1:])
    conv = F.conv2d if weight.dim() == 4 else F.conv3d
    return conv(xp, weight, bias, padding=pad)


def halo_conv2d(x, weight, mesh, axis="space", bias=None):
    """SAME conv2d of NHWC `x` (B, H_local, W, C) with H split over mesh
    `axis`; weight (C_out, C_in, kh, kw), odd kh and kw. Returns
    (B, H_local, W, C_out), split the same way."""
    y = sharded_conv(x.permute(0, 3, 1, 2), weight, bias, mesh.axis(axis))
    return y.permute(0, 2, 3, 1)


def halo_conv3d(x, weight, mesh, axis="space", bias=None):
    """SAME conv3d of (B, D_local, H, W, C) `x` with D split over mesh
    `axis`; weight (C_out, C_in, kd, kh, kw), odd sizes. Returns
    (B, D_local, H, W, C_out), split the same way."""
    y = sharded_conv(x.permute(0, 4, 1, 2, 3), weight, bias, mesh.axis(axis))
    return y.permute(0, 2, 3, 4, 1)
