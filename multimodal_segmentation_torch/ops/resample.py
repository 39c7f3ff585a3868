"""Bilinear resampling, the plain PyTorch version of the warp's gather.

Port of multimodal_segmentation_tpu/ops/resample.py:17-56 with the batch
written out: bilinear blend of the four neighbouring pixels, where a corner
that falls outside the image contributes zero (TF resampler semantics).
"""

import torch


def bilinear_sample(img, coords_yx):
    """Sample `img` at fractional pixel coordinates.

    Args:
      img: (B, H, W, C) source images.
      coords_yx: (B, M, 2) float (y, x) pixel coordinates.

    Returns:
      (B, M, C) sampled values; out-of-range corner contributions are zero.
    """
    B, H, W, C = img.shape
    y = coords_yx[..., 0]
    x = coords_yx[..., 1]

    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = y0 + 1.0
    x1 = x0 + 1.0

    wy1 = y - y0  # weight of the y1 row
    wx1 = x - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1

    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        """img[b, yi, xi] with out-of-range corners zeroed."""
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        idx = (yc * W + xc).unsqueeze(-1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx)
        return vals * valid.unsqueeze(-1).to(img.dtype)

    return (
        gather(y0, x0) * (wy0 * wx0).unsqueeze(-1)
        + gather(y0, x1) * (wy0 * wx1).unsqueeze(-1)
        + gather(y1, x0) * (wy1 * wx0).unsqueeze(-1)
        + gather(y1, x1) * (wy1 * wx1).unsqueeze(-1)
    )
