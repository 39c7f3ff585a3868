"""LSGAN discriminator with the spectral-norm penalty on its downsample
convolutions.

Port of multimodal_segmentation_tpu/nn/discriminator.py:25-90 (reference
models/discriminator.py:9-45, layers/spectralnorm.py:199-246). NCHW
inside; the Dense head takes the activation flattened in NHWC order, as
the JAX package flattens.

Each SpectralConv keeps its power-iteration vector `u` as a buffer. It is
updated only when the caller asks for the penalty (`collect_spectral=True`,
the discriminator's own loss, models/dafnet.py:180-187); the generator
loss scores with the discriminator as it stands and leaves `u` alone.
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import Conv2d, Linear, leaky_relu
from multimodal_segmentation_torch.ops.spectral import hwio_matrix, spectral_penalty


def _valid_hw(n, k, stride):
    return (n - k) // stride + 1


class SpectralConv(Conv2d):
    """VALID 4x4 conv (he_normal kernel) whose kernel carries the spectral
    penalty; `u` starts uniform in [-1, 1) (spectralnorm.py:213)."""

    def __init__(self, in_ch, features, stride=2, alpha=10.0):
        super().__init__(in_ch, features, 4, padding="VALID", init="he_normal",
                         stride=stride)
        self.alpha = alpha
        self.register_buffer("u", torch.empty(16 * in_ch, 1))

    def flax_init_(self, generator):
        super().flax_init_(generator)
        self.u.copy_(torch.rand(self.u.shape, generator=generator) * 2.0 - 1.0)

    def penalty(self):
        """The penalty from the current kernel and `u`; the new
        power-iteration vector replaces `u` (in place)."""
        penalty, new_u = spectral_penalty(hwio_matrix(self.weight), self.u, self.alpha)
        self.u.copy_(new_u)
        return penalty


class Discriminator(nn.Module):
    """Conv 4x4/2 -> LeakyReLU(0.2) -> `downsample_blocks` SpectralConvs
    (stride 2, the last stride 1), each with LeakyReLU(0.2) -> f32 Dense(1)
    (models/discriminator.py:16-42)."""

    def __init__(self, in_ch, input_hw, filters=64, downsample_blocks=3,
                 dtype=torch.float32):
        super().__init__()
        if downsample_blocks <= 1:
            raise ValueError("Discriminator needs more than one downsample block")
        self.dtype = dtype
        self.blocks = downsample_blocks
        self.Conv_0 = Conv2d(in_ch, filters, 4, padding="VALID", init="he_normal", stride=2)
        h, w = (_valid_hw(n, 4, 2) for n in input_hw)
        ch = filters
        for i in range(downsample_blocks):
            stride = 1 if i == downsample_blocks - 1 else 2
            out = filters * 2 * 2 ** i
            self.add_module("SpectralConv_%d" % i, SpectralConv(ch, out, stride))
            h, w, ch = _valid_hw(h, 4, stride), _valid_hw(w, 4, stride), out
        self.Dense_0 = Linear(h * w * ch, 1)

    def spectral_convs(self):
        return [getattr(self, "SpectralConv_%d" % i) for i in range(self.blocks)]

    def forward(self, x, collect_spectral=False):
        """x: (B, C, H, W). Returns the (B, 1) f32 scores and, with
        `collect_spectral`, the summed spectral penalty (each `u` updated);
        without it, None."""
        x = leaky_relu(self.Conv_0(x.to(self.dtype)), 0.2)
        for conv in self.spectral_convs():
            x = leaky_relu(conv(x), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        out = self.Dense_0(x.float())
        if not collect_spectral:
            return out, None
        return out, sum(conv.penalty() for conv in self.spectral_convs())
