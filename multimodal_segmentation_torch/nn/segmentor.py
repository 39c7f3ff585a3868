"""Segmentor: anatomy channels -> softmax masks (+1 background channel).

Port of multimodal_segmentation_tpu/nn/segmentor.py:14-48 (reference
model_components/segmentor.py:9-29). NCHW tensors.
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_segmentation_torch.nn.blocks import BatchNorm, Conv2d


class Segmentor(nn.Module):
    def __init__(self, in_ch=8, num_masks=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(in_ch, 64, 3, init="he_normal")
        self.BatchNorm_0 = BatchNorm(64)
        self.Conv_1 = Conv2d(64, 64, 3, init="he_normal")
        self.BatchNorm_1 = BatchNorm(64)
        self.Conv_2 = Conv2d(64, num_masks + 1, 1)

    def forward(self, s, groups=1):
        """`groups`: in train mode the step segments several anatomy maps
        in one interleaved call, and BatchNorm keeps per-map statistics."""
        x = F.relu(self.BatchNorm_0(self.Conv_0(s.to(self.dtype)), groups))
        x = F.relu(self.BatchNorm_1(self.Conv_1(x), groups))
        # softmax in f32: mask probabilities feed Dice
        return torch.softmax(self.Conv_2(x).float(), dim=1)
