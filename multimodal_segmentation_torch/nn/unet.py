"""Configurable-depth UNet halves (port of multimodal_segmentation_tpu/nn/unet.py:17-73).

Split into Down / Bottleneck / Up so the DAFNet dual encoder composes them
with private down paths and a shared decoder. NCHW tensors; `groups` goes
to every BatchNorm (train-mode per-group statistics).
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import ConvBlock, UpsampleBlock, max_pool2


class UNetDown(nn.Module):
    """Downsample path; returns (bottom_input, skips) (models/unet.py:37-52).
    skips[i] is the pre-pool activation at level i."""

    def __init__(self, in_ch, filters=64, downsample=4, norm="batch"):
        super().__init__()
        if downsample <= 0:
            raise ValueError("Unet downsample must be over 0.")
        self.downsample = downsample
        for level in range(downsample):
            f = filters * 2 ** level
            self.add_module("ConvBlock_%d" % level, ConvBlock(in_ch, f, norm))
            in_ch = f

    def forward(self, x, groups=1):
        skips = []
        for level in range(self.downsample):
            s = getattr(self, "ConvBlock_%d" % level)(x, groups)
            skips.append(s)
            x = max_pool2(s)
        return x, skips


class UNetBottleneck(nn.Module):
    """Bottleneck conv block (models/unet.py:54-63): filters * 2^downsample."""

    def __init__(self, filters=64, downsample=4, norm="batch"):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(
            filters * 2 ** (downsample - 1), filters * 2 ** downsample, norm
        )

    def forward(self, x, groups=1):
        return self.ConvBlock_0(x, groups)


class UNetUp(nn.Module):
    """Upsample path with skip concatenation (models/unet.py:65-86)."""

    def __init__(self, filters=64, downsample=4, norm="batch"):
        super().__init__()
        self.downsample = downsample
        in_ch = filters * 2 ** downsample
        for i, level in enumerate(reversed(range(downsample))):
            f = filters * 2 ** level
            self.add_module("UpsampleBlock_%d" % i, UpsampleBlock(in_ch, f, norm))
            self.add_module("ConvBlock_%d" % i, ConvBlock(2 * f, f, norm))
            in_ch = f

    def forward(self, x, skips, groups=1):
        for i, level in enumerate(reversed(range(self.downsample))):
            x = getattr(self, "UpsampleBlock_%d" % i)(x, groups)
            x = torch.cat([x, skips[level]], dim=1)
            x = getattr(self, "ConvBlock_%d" % i)(x, groups)
        return x
