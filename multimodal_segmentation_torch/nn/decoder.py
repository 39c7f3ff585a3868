"""Decoder: render an image from (anatomy s, modality z).

Port of the FiLM path of multimodal_segmentation_tpu/nn/decoder.py:21-55
and its dispatch (:139-152) (reference model_components/decoder.py:44-65,
layers/film.py:26-36). NCHW tensors. The SPADE decoder is still to be
ported (ROADMAP.md, queue A).
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import Conv2d, Linear, leaky_relu


class FiLMLayer(nn.Module):
    """Residual FiLM block: conv -> LeakyReLU, conv modulated by gamma/beta
    predicted from z -> LeakyReLU, plus the first activation."""

    def __init__(self, num_z, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(8, 8, 3)
        self.Conv_1 = Conv2d(8, 8, 3)
        self.Dense_0 = Linear(num_z, 8)
        self.Dense_1 = Linear(num_z, 8)

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


class Decoder(nn.Module):
    """Dispatch on decoder_type like decoder.py:12-33 ('film' only so far)."""

    def __init__(self, decoder_type, in_ch, num_z, dtype=torch.float32):
        super().__init__()
        if decoder_type == "spade":
            raise NotImplementedError(
                "the SPADE decoder is not ported yet (ROADMAP.md, queue A, item 3)"
            )
        if decoder_type != "film":
            raise ValueError("Unknown decoder_type: %s" % decoder_type)
        self.FiLMDecoder_0 = FiLMDecoder(in_ch, num_z, dtype)

    def forward(self, s, z):
        """s (B, S, H, W) anatomy, z (B, num_z) -> (B, 1, H, W) f32 image."""
        return self.FiLMDecoder_0(s, z)
