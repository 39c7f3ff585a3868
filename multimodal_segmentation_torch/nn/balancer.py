"""Balancer: similarity weights over candidate deformed anatomies.

Port of multimodal_segmentation_tpu/nn/balancer.py:12-29 (reference
model_components/balancer.py:11-38): the soft Dice overlap of the target
anatomy with each of n_pairs candidates, then Dense(5) -> ReLU ->
Dense(n_pairs) -> softmax. Only automated pairing uses it; the expert
step leaves its parameters unchanged. NCHW tensors.
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_segmentation_torch.nn.blocks import Linear


def _overlap_dice(a, b, smooth=1e-12):
    """Soft Dice overlap per sample, shape (B, 1) (balancer.py:33-38)."""
    inter = torch.sum(a * b, dim=(1, 2, 3))
    union = torch.sum(a, dim=(1, 2, 3)) + torch.sum(b, dim=(1, 2, 3))
    return ((2.0 * inter + smooth) / (union + smooth))[:, None]


class Balancer(nn.Module):
    def __init__(self, n_pairs=3):
        super().__init__()
        self.Dense_0 = Linear(n_pairs, 5)
        self.beta = Linear(5, n_pairs)

    def forward(self, s_target, s_candidates):
        """s_target (B, S, H, W); s_candidates: n_pairs such maps.
        Returns (B, n_pairs) softmax weights."""
        x = torch.cat([_overlap_dice(s_target, s) for s in s_candidates], dim=-1)
        return torch.softmax(self.beta(F.relu(self.Dense_0(x))), dim=-1)
