"""Segmentor: anatomy channels -> softmax masks (+1 background channel).

Port of multimodal_segmentation_tpu/nn/segmentor.py:14-48 (reference
model_components/segmentor.py:9-29). NCHW tensors.
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import BatchNorm, Conv2d, conv_norm, remat


class Segmentor(nn.Module):
    """With `remat`, in train mode the whole body is rematerialised
    (nn/blocks.py::remat; nn/segmentor.py:17-26 of the JAX package)."""

    def __init__(self, in_ch=8, num_masks=4, dtype=torch.float32, remat=False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.Conv_0 = Conv2d(in_ch, 64, 3, init="he_normal")
        self.BatchNorm_0 = BatchNorm(64)
        self.Conv_1 = Conv2d(64, 64, 3, init="he_normal")
        self.BatchNorm_1 = BatchNorm(64)
        self.Conv_2 = Conv2d(64, num_masks + 1, 1)

    def forward(self, s, groups=1):
        """`groups`: in train mode the step segments several anatomy maps
        in one interleaved call, and BatchNorm keeps per-map statistics."""
        if self.remat and self.training:
            return remat(self, self._body, s, groups)
        return self._body(s, groups)

    def _body(self, s, groups):
        x = conv_norm(self.Conv_0, self.BatchNorm_0, s.to(self.dtype), groups)
        x = conv_norm(self.Conv_1, self.BatchNorm_1, x, groups)
        # softmax in f32: mask probabilities feed Dice
        return torch.softmax(self.Conv_2(x).float(), dim=1)
