"""Decoders: render an image from (anatomy s, modality z).

Port of multimodal_segmentation_tpu/nn/decoder.py: the FiLM path (:21-55),
the SPADE path (:58-136) and the dispatch (:139-152) (reference
model_components/decoder.py:44-81, layers/film.py:26-36,
layers/spade.py:7-38). NCHW tensors.
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_segmentation_torch.nn.blocks import (
    Conv2d,
    InstanceNorm,
    Linear,
    leaky_relu,
    upsample2x,
)


class FiLMLayer(nn.Module):
    """Residual FiLM block: conv -> LeakyReLU, conv modulated by gamma/beta
    predicted from z -> LeakyReLU, plus the first activation."""

    def __init__(self, num_z, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(8, 8, 3)
        self.Conv_1 = Conv2d(8, 8, 3)
        self.Dense_0 = Linear(num_z, 8, dtype=dtype)
        self.Dense_1 = Linear(num_z, 8, dtype=dtype)

    def forward(self, h, z):
        l1 = leaky_relu(self.Conv_0(h))
        l2 = self.Conv_1(l1)
        gamma = leaky_relu(self.Dense_0(z))
        beta = leaky_relu(self.Dense_1(z))
        l2 = leaky_relu(l2 * gamma[:, :, None, None] + beta[:, :, None, None])
        return l1 + l2


class FiLMDecoder(nn.Module):
    """conv 8 + 4 residual FiLM layers + f32 1x1 tanh conv (glorot_normal)
    (decoder.py:57-65, :28)."""

    def __init__(self, in_ch, num_z, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(in_ch, 8, 3)
        for i in range(4):
            self.add_module("FiLMLayer_%d" % i, FiLMLayer(num_z, dtype))
        self.Conv_1 = Conv2d(8, 1, 1, init="glorot_normal")

    def forward(self, s, z):
        z = z.to(self.dtype)
        h = leaky_relu(self.Conv_0(s.to(self.dtype)))
        for i in range(4):
            h = getattr(self, "FiLMLayer_%d" % i)(h, z)
        return torch.tanh(self.Conv_1(h.float()))


def _resize_nearest(x, hw):
    """Nearest-neighbour resize to `hw` as jax.image.resize(method=
    "nearest") does it: output pixel i samples the input at its half-pixel
    centre, floor((i + 0.5) * in / out) ('nearest-exact'; 'nearest' would
    take floor(i * in / out))."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class SPADEUnit(nn.Module):
    """One SPADE conditioning (layers/spade.py:26-33): instance norm without
    scale or bias, then a spatial gamma and beta predicted from the anatomy
    resized to h's size: h_norm * (1 + gamma) + beta."""

    def __init__(self, in_ch, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.InstanceNorm_0 = InstanceNorm(features, use_scale=False, use_bias=False)
        self.Conv_0 = Conv2d(in_ch, 128, 3)
        self.Conv_1 = Conv2d(128, features, 3)
        self.Conv_2 = Conv2d(128, features, 3)

    def forward(self, s, h):
        h_norm = self.InstanceNorm_0(h)
        a = _resize_nearest(s, h.shape[2:]).to(self.dtype)
        a = F.relu(self.Conv_0(a))
        return h_norm * (1.0 + self.Conv_1(a)) + self.Conv_2(a)


class SPADEBlock(nn.Module):
    """Residual SPADE block (layers/spade.py:7-23), its LeakyReLUs with
    slope 0.2 (decoder.py:93, :96); the learned shortcut, a SPADE unit and
    a 1x1 conv without bias, exists only when fin != fout."""

    def __init__(self, in_ch, fin, fout, dtype=torch.float32):
        super().__init__()
        fmiddle = min(fin, fout)
        self.SPADEUnit_0 = SPADEUnit(in_ch, fin, dtype)
        self.Conv_0 = Conv2d(fin, fmiddle, 3)
        self.SPADEUnit_1 = SPADEUnit(in_ch, fmiddle, dtype)
        self.Conv_1 = Conv2d(fmiddle, fout, 3)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.SPADEUnit_2 = SPADEUnit(in_ch, fin, dtype)
            self.Conv_2 = Conv2d(fin, fout, 1, bias=False)

    def forward(self, s, h):
        x = self.Conv_0(leaky_relu(self.SPADEUnit_0(s, h), 0.2))
        x = self.Conv_1(leaky_relu(self.SPADEUnit_1(s, x), 0.2))
        sc = self.Conv_2(self.SPADEUnit_2(s, h)) if self.learned_shortcut else h
        return sc + x


# (fin, fout) of the six SPADE blocks, at H/32 .. H (decoder.py:122-133)
SPADE_BLOCKS = ((128, 128), (128, 128), (128, 128), (128, 64), (64, 32), (32, 16))


class SPADEDecoder(nn.Module):
    """z -> Dense (in the compute dtype) -> (128, H/32, W/32) -> six SPADE
    blocks with a 2x upsampling between each two -> f32 1x1 tanh conv
    (glorot_normal) (decoder.py:103-136)."""

    def __init__(self, in_ch, num_z, input_hw, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hw0 = (input_hw[0] // 32, input_hw[1] // 32)
        self.Dense_0 = Linear(num_z, self.hw0[0] * self.hw0[1] * 128, dtype=dtype)
        for i, (fin, fout) in enumerate(SPADE_BLOCKS):
            self.add_module("SPADEBlock_%d" % i, SPADEBlock(in_ch, fin, fout, dtype))
        self.Conv_0 = Conv2d(SPADE_BLOCKS[-1][1], 1, 1, init="glorot_normal")

    def forward(self, s, z):
        s = s.to(self.dtype)
        # the Dense's output is NHWC in the JAX package
        h = self.Dense_0(z.to(self.dtype)).reshape(-1, *self.hw0, 128).permute(0, 3, 1, 2)
        for i in range(len(SPADE_BLOCKS)):
            if i:
                h = upsample2x(h)
            h = getattr(self, "SPADEBlock_%d" % i)(s, h)
        return torch.tanh(self.Conv_0(h.float()))


class Decoder(nn.Module):
    """Dispatch on decoder_type ('film' | 'spade') like decoder.py:12-33."""

    def __init__(self, decoder_type, in_ch, num_z, dtype=torch.float32, input_hw=(192, 192)):
        super().__init__()
        if decoder_type == "film":
            self.FiLMDecoder_0 = FiLMDecoder(in_ch, num_z, dtype)
        elif decoder_type == "spade":
            self.SPADEDecoder_0 = SPADEDecoder(in_ch, num_z, input_hw, dtype)
        else:
            raise ValueError("Unknown decoder_type: %s" % decoder_type)

    def forward(self, s, z):
        """s (B, S, H, W) anatomy, z (B, num_z) -> (B, 1, H, W) f32 image."""
        (impl,) = self.children()
        return impl(s, z)
