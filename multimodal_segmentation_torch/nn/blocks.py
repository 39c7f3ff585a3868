"""Shared building blocks, inference side: convs, BatchNorm with running
statistics, conv blocks, upsampling, pooling.

Port of multimodal_segmentation_tpu/nn/blocks.py (reference
models/unet.py:94-101, utils/model_utils.py:6-24). Tensors are NCHW.
Parameters stay f32; a module computes in its input's dtype. Submodules
carry the Flax auto-names (Conv_0, Norm_0, ...) so utils/convert.py maps
the JAX package's parameters onto them by name.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2]: Flax's variance_scaling
# 'truncated_normal' divides by it
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w, scale, fan_in, generator):
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv2d(nn.Conv2d):
    """Flax nn.Conv counterpart: stride 1, 'SAME' (odd kernels: symmetric
    pad k//2) or 'VALID' padding, he_normal or lecun_normal kernels."""

    def __init__(self, in_ch, out_ch, k, padding="SAME", init="lecun_normal"):
        super().__init__(in_ch, out_ch, k, padding=k // 2 if padding == "SAME" else 0)
        self.init_kind = init

    def flax_init_(self, generator):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        scale = 2.0 if self.init_kind == "he_normal" else 1.0
        _variance_scaling_(self.weight, scale, fan_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class Linear(nn.Linear):
    """Flax nn.Dense counterpart (lecun_normal or zero kernel, zero bias)."""

    def __init__(self, in_features, out_features, init="lecun_normal"):
        super().__init__(in_features, out_features)
        self.init_kind = init

    def flax_init_(self, generator):
        if self.init_kind == "zeros":
            nn.init.zeros_(self.weight)
        else:
            _variance_scaling_(self.weight, 1.0, self.in_features, generator)
        nn.init.zeros_(self.bias)


def flax_init_(module, generator):
    """Initialise every Conv2d/Linear under `module` as Flax would, drawing
    from `generator` (BatchNorm keeps weight 1, bias 0, mean 0, var 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv2d, Linear)):
                m.flax_init_(generator)


class BatchNorm(nn.Module):
    """BatchNorm over channels with running statistics (eval mode).

    Port of nn/blocks.py:100-126 with use_running_average: eps 1e-3, f32
    statistics and affine parameters, normalisation in the input's dtype in
    the JAX package's order ((x - mean) * (rsqrt(var + eps) * scale) + bias).
    Grouped train-mode batch statistics come with the training slice.
    """

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode (grouped) BatchNorm is not ported yet "
                "(ROADMAP.md, queue A, slice 2); call model.eval()"
            )
        dt = x.dtype
        shape = (1, -1, 1, 1)
        mean = self.running_mean.to(dt).view(shape)
        var = self.running_var.to(dt).view(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt).view(shape)
        return (x - mean) * mul + self.bias.to(dt).view(shape)


def _norm(kind, channels):
    """Normalisation by name (utils/model_utils.py:6-13); every preset uses
    'batch'."""
    if kind == "batch":
        return BatchNorm(channels)
    raise NotImplementedError(
        "normalisation '%s' is not ported yet (ROADMAP.md, queue A)" % kind
    )


def leaky_relu(x, alpha=0.3):
    """Keras LeakyReLU default slope 0.3."""
    return F.leaky_relu(x, alpha)


class ConvBlock(nn.Module):
    """[Conv3x3(he_normal) -> norm -> relu] x 2 (models/unet.py:94-101)."""

    def __init__(self, in_ch, filters, norm="batch"):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = _norm(norm, filters)
        self.Conv_1 = Conv2d(filters, filters, 3, init="he_normal")
        self.Norm_1 = _norm(norm, filters)

    def forward(self, x):
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.relu(self.Norm_1(self.Conv_1(x)))


def upsample2x(x):
    """Nearest-neighbour 2x upsampling (Keras UpSampling2D)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class UpsampleBlock(nn.Module):
    """Upsample2x -> Conv3x3 -> norm (utils/model_utils.py:15-24) with the
    'linear' activation, the only one its caller (UNetUp) uses."""

    def __init__(self, in_ch, filters, norm="batch"):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = _norm(norm, filters)

    def forward(self, x):
        return self.Norm_0(self.Conv_0(upsample2x(x)))


def max_pool2(x):
    """2x2/stride-2 max pooling as reshape + amax; floor pooling for odd
    sizes (nn/blocks.py:263-278)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        return F.max_pool2d(x, 2, 2)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
