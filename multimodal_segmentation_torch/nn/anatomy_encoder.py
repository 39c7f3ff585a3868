"""Anatomy encoders: UNet body -> 1x1 conv -> f32 softmax -> straight-through
rounding.

Port of multimodal_segmentation_tpu/nn/anatomy_encoder.py (reference
model_components/anatomy_encoder.py):
* `AnatomyEncoder` (:25-53) = the single-modality encoder of MMSDNet.
* `DualAnatomyEncoder` (:56-133) = the DAFNet variant: each modality has a
  private down path; the bottleneck, the up path and the final 1x1 conv
  are shared.
NCHW tensors; the softmax runs over the channel dim. `remat` goes to every
UNet block (nn/blocks.py::remat).
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import Conv2d
from multimodal_segmentation_torch.nn.unet import UNetBottleneck, UNetDown, UNetUp
from multimodal_segmentation_torch.ops.batching import batch_deinterleave, batch_interleave
from multimodal_segmentation_torch.ops.rounding import round_ste


def _anatomy_head(conv, h, rounding, dtype):
    """1x1 conv, softmax in f32 for stability, output in the compute dtype,
    then rounding to {0, 1}."""
    s = torch.softmax(conv(h).float(), dim=1).to(dtype)
    return round_ste(s) if rounding else s


class AnatomyEncoder(nn.Module):
    """Single-modality anatomy encoder (anatomy_encoder.py:13-30)."""

    def __init__(self, in_ch=1, filters=64, downsample=4, norm="batch",
                 out_channels=8, rounding=True, dtype=torch.float32, remat=False):
        super().__init__()
        self.rounding = rounding
        self.dtype = dtype
        self.UNetDown_0 = UNetDown(in_ch, filters, downsample, norm, remat)
        self.UNetBottleneck_0 = UNetBottleneck(filters, downsample, norm, remat)
        self.UNetUp_0 = UNetUp(filters, downsample, norm, remat)
        self.conv_anatomy = Conv2d(filters, out_channels, 1)

    def forward(self, x):
        x, skips = self.UNetDown_0(x.to(self.dtype))
        x = self.UNetUp_0(self.UNetBottleneck_0(x), skips)
        return _anatomy_head(self.conv_anatomy, x, self.rounding, self.dtype)


class DualAnatomyEncoder(nn.Module):
    """Two anatomy encoders with private downsampling and a shared decoder
    (anatomy_encoder.py:32-73)."""

    def __init__(self, in_ch=1, filters=64, downsample=4, norm="batch",
                 out_channels=8, rounding=True, dtype=torch.float32, remat=False):
        super().__init__()
        self.rounding = rounding
        self.dtype = dtype
        self.down1 = UNetDown(in_ch, filters, downsample, norm, remat)
        self.down2 = UNetDown(in_ch, filters, downsample, norm, remat)
        self.shared_bottleneck = UNetBottleneck(filters, downsample, norm, remat)
        self.shared_up = UNetUp(filters, downsample, norm, remat)
        self.conv_anatomy = Conv2d(filters, out_channels, 1)

    def forward(self, x1, x2, pair_groups=1):
        """Encode both modalities with one pass through the shared path on
        the interleaved (2B, ...) stack. In train mode every BatchNorm keeps
        per-modality statistics: `pair_groups` groups on each private path,
        2 * pair_groups on the shared path (anatomy_encoder.py:98-133)."""
        if x1.shape[0] != x2.shape[0]:
            raise ValueError(
                "DualAnatomyEncoder requires equal batch sizes per modality: "
                f"got {x1.shape[0]} vs {x2.shape[0]}"
            )
        h1, skips1 = self.down1(x1.to(self.dtype), pair_groups)
        h2, skips2 = self.down2(x2.to(self.dtype), pair_groups)
        h = batch_interleave([h1, h2])
        skips = [batch_interleave([a, b]) for a, b in zip(skips1, skips2)]
        g = 2 * pair_groups
        h = self.shared_up(self.shared_bottleneck(h, g), skips, g)
        s = _anatomy_head(self.conv_anatomy, h, self.rounding, self.dtype)
        s1, s2 = batch_deinterleave(s, 2)
        return s1, s2

    def _encode(self, down, x):
        h, skips = down(x.to(self.dtype))
        h = self.shared_up(self.shared_bottleneck(h), skips)
        return _anatomy_head(self.conv_anatomy, h, self.rounding, self.dtype)

    def encode1(self, x):
        """Modality 1 alone through its private path and the shared one
        (anatomy_encoder.py:135-137): the balancer's validation encodes
        each candidate slice so (train/executor.py)."""
        return self._encode(self.down1, x)

    def encode2(self, x):
        """Modality 2 alone (anatomy_encoder.py:139-140)."""
        return self._encode(self.down2, x)
