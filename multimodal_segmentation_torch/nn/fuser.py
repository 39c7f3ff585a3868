"""Anatomy fuser: LocNet predicts TPS control-point offsets; the first
anatomy is deformed into the second's space and fused with pixelwise max.

Port of multimodal_segmentation_tpu/nn/fuser.py:18-122 (reference
model_components/anatomy_fuser.py:12-38, layers/stn_spline.py:94-118).
NCHW tensors; the warp itself takes channels-last (B, H, W, C).
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import Conv2d, Linear, leaky_relu, max_pool2
from multimodal_segmentation_torch.ops.tps import tps_warp


def _locnet_hw(n):
    """Spatial size after LocNet's three VALID 5x5 convs and two pools."""
    n = (n - 4) // 2
    n = (n - 4) // 2
    return n - 4


class LocNet(nn.Module):
    """Localisation net predicting 5x5x2 control-point offsets.

    The last Dense is zero-initialised, so an untrained fuser starts at the
    identity warp (stn_spline.py:116).
    """

    def __init__(self, in_ch, input_hw, cp_points=25, dtype=torch.float32):
        super().__init__()
        self.cp_points = cp_points
        self.dtype = dtype
        self.Conv_0 = Conv2d(in_ch, 20, 5, padding="VALID")
        self.Conv_1 = Conv2d(20, 20, 5, padding="VALID")
        self.Conv_2 = Conv2d(20, 20, 5, padding="VALID")
        flat = 20 * _locnet_hw(input_hw[0]) * _locnet_hw(input_hw[1])
        self.Dense_0 = Linear(flat, 100)
        self.Dense_1 = Linear(100, cp_points * 2, init="zeros")

    def forward(self, s1, s2):
        x = torch.cat([s1.to(self.dtype), s2.to(self.dtype)], dim=1)
        x = max_pool2(leaky_relu(self.Conv_0(x)))
        x = max_pool2(leaky_relu(self.Conv_1(x)))
        x = leaky_relu(self.Conv_2(x))
        # Dense_0 holds rows in NHWC flatten order, as the JAX package
        # flattens: permute the activation, never the weight
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        # offset head in f32: zero-init + sub-pixel offsets need range
        x = torch.tanh(self.Dense_0(x.float()))
        return self.Dense_1(x).reshape(-1, self.cp_points, 2)


class AnatomyFuser(nn.Module):
    """Deform s1 into s2's space with the TPS-STN; fuse with max
    (anatomy_fuser.py:28-33).

    The device picks the warp: the CUDA kernel on the GPU, the plain
    version on the CPU. On the GPU the kernel warps a bf16 copy of s1 under
    a bf16 compute dtype, and also under f32 compute when `fast` is asked
    for (predict_mask only) and eval_blend_bf16 is set (eval_warp='bf16');
    it accumulates in f32 either way. On the CPU the warp is f32, as the
    JAX package's jnp path is.
    """

    def __init__(self, in_ch, input_hw, cp_dims=(5, 5), dtype=torch.float32,
                 eval_blend_bf16=False):
        super().__init__()
        self.cp_dims = tuple(cp_dims)
        self.dtype = dtype
        self.eval_blend_bf16 = eval_blend_bf16
        self.locnet = LocNet(2 * in_ch, input_hw, cp_dims[0] * cp_dims[1], dtype)

    def forward(self, s1, s2, fast=False):
        theta = self.locnet(s1, s2)
        fast_eval = fast and not self.training and self.eval_blend_bf16
        bf16_src = s1.is_cuda and (self.dtype == torch.bfloat16 or fast_eval)
        src = s1.to(torch.bfloat16 if bf16_src else torch.float32)
        s1_def = tps_warp(
            src.permute(0, 2, 3, 1).contiguous(), theta.float(), self.cp_dims
        ).permute(0, 3, 1, 2).to(s1.dtype)
        return s1_def, torch.maximum(s1_def, s2)
