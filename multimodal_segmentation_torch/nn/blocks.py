"""Shared building blocks: convs, grouped BatchNorm, conv blocks,
upsampling, pooling.

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


def _fan(init_kind, fan_in, fan_out):
    """(scale, fan) of Flax's he_normal, lecun_normal and glorot_normal."""
    if init_kind == "he_normal":
        return 2.0, fan_in
    if init_kind == "glorot_normal":
        return 1.0, (fan_in + fan_out) / 2.0
    return 1.0, fan_in


class Conv2d(nn.Conv2d):
    """Flax nn.Conv counterpart: 'SAME' (odd kernels, stride 1: symmetric
    pad k//2) or 'VALID' padding, he_normal, lecun_normal or glorot_normal
    kernels, zero bias."""

    def __init__(self, in_ch, out_ch, k, padding="SAME", init="lecun_normal", stride=1):
        if padding == "SAME" and stride != 1:
            raise ValueError("SAME padding is ported for stride 1 only")
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=k // 2 if padding == "SAME" else 0)
        self.init_kind = init

    def flax_init_(self, generator):
        kk = self.kernel_size[0] * self.kernel_size[1]
        scale, fan = _fan(self.init_kind, self.in_channels * kk, self.out_channels * kk)
        _variance_scaling_(self.weight, scale, fan, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=self.padding)


class Linear(nn.Linear):
    """Flax nn.Dense counterpart (lecun_normal, he_normal or zero kernel,
    zero bias)."""

    def __init__(self, in_features, out_features, init="lecun_normal"):
        super().__init__(in_features, out_features)
        self.init_kind = init

    def flax_init_(self, generator):
        if self.init_kind == "zeros":
            nn.init.zeros_(self.weight)
        else:
            scale, fan = _fan(self.init_kind, self.in_features, self.out_features)
            _variance_scaling_(self.weight, scale, fan, generator)
        nn.init.zeros_(self.bias)


def flax_init_(module, generator):
    """Initialise every module under `module` that has a `flax_init_`
    (Conv2d, Linear, SpectralConv) as Flax would, drawing from `generator`
    in module order (BatchNorm keeps weight 1, bias 0, mean 0, var 1)."""
    with torch.no_grad():
        for m in module.modules():
            if m is not module and hasattr(m, "flax_init_"):
                m.flax_init_(generator)


class BatchNorm(nn.Module):
    """BatchNorm over channels with optional per-group batch statistics.

    Port of nn/blocks.py:18-126 (Keras momentum 0.99, eps 1e-3). Statistics,
    scale and bias are f32; the normalisation runs in the input's dtype in
    the JAX package's order ((x - mean) * (rsqrt(var + eps) * scale) + bias).

    Eval mode normalises with the running statistics. Train mode with
    `groups=G` normalises the (B*G, C, H, W) input with statistics over
    each interleaved group (row b*G + g is group g's sample b): per-group
    f32 mean and biased variance max(E[x^2] - mean^2, 0). It then updates
    the running statistics once, in place and outside autograd, from the
    mean of the group moments. nn.BatchNorm2d keeps an unbiased running
    variance and knows no groups, so it is not used.
    """

    momentum = 0.99

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, groups=1):
        dt = x.dtype
        n, c = x.shape[:2]
        if not self.training:
            groups = 1
            mean = self.running_mean[None]                   # (1, C)
            var = self.running_var[None]
        elif n % groups:
            raise ValueError("grouped BatchNorm needs batch divisible by "
                             "groups: batch=%d, groups=%d" % (n, groups))
        xg = x.reshape((n // groups, groups) + tuple(x.shape[1:]))
        if self.training:
            xf = xg.float()
            mean = xf.mean(dim=(0, 3, 4))                    # (G, C)
            var = torch.maximum(xf.square().mean(dim=(0, 3, 4)) - mean.square(),
                                torch.zeros((), device=x.device))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.mean(0))
                self.running_var.mul_(m).add_((1 - m) * var.mean(0))
        shape = (1, groups, c, 1, 1)
        mul = torch.rsqrt(var.to(dt).view(shape) + self.eps) * self.weight.to(dt).view(1, 1, c, 1, 1)
        y = (xg - mean.to(dt).view(shape)) * mul + self.bias.to(dt).view(1, 1, c, 1, 1)
        return y.reshape(x.shape)


def _norm(kind, channels):
    """Normalisation by name (utils/model_utils.py:6-13); every preset uses
    'batch'."""
    if kind == "batch":
        return BatchNorm(channels)
    raise NotImplementedError(
        "normalisation '%s' is not ported yet (ROADMAP.md, queue A)" % kind
    )


def leaky_relu(x, alpha=0.3):
    """Keras LeakyReLU, default slope 0.3. Written as jax.nn.leaky_relu is,
    where(x >= 0, x, alpha * x), so that the gradient at exactly 0 is 1 as
    in the JAX package (F.leaky_relu gives alpha there; exact zeros are
    common, e.g. a conv over an empty anatomy region)."""
    return torch.where(x >= 0, x, alpha * x)


class ConvBlock(nn.Module):
    """[Conv3x3(he_normal) -> norm -> relu] x 2 (models/unet.py:94-101)."""

    def __init__(self, in_ch, filters, norm="batch"):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = _norm(norm, filters)
        self.Conv_1 = Conv2d(filters, filters, 3, init="he_normal")
        self.Norm_1 = _norm(norm, filters)

    def forward(self, x, groups=1):
        x = F.relu(self.Norm_0(self.Conv_0(x), groups))
        return F.relu(self.Norm_1(self.Conv_1(x), groups))


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

    def forward(self, x, groups=1):
        return self.Norm_0(self.Conv_0(upsample2x(x)), groups)


def max_pool2(x):
    """2x2/stride-2 max pooling as reshape + amax; floor pooling for odd
    sizes (nn/blocks.py:263-278)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        return F.max_pool2d(x, 2, 2)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
