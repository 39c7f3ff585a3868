"""3-D UNet of the volumetric cardiac path.

Port of multimodal_segmentation_tpu/nn/unet3d.py:34-117: conv blocks with
skip connections over (D, H, W) volumes, pooling and upsampling on H and W
only (cardiac MR is anisotropic, so the slice axis D is never pooled),
instance norm over (D, H, W) in f32. At the boundary of `UNet3D` tensors
are channels-last (B, D, H, W, C), as the loader and the loss have them;
the blocks inside are channels-first (B, C, D, H, W), as conv3d wants.
Parameters stay f32; under a bf16 `dtype` every conv but the last
computes in bf16, as in the JAX package. Submodules carry the Flax
auto-names (ConvBlock3D_0, Conv_0, InstanceNorm3D_0, ...), so
utils/convert.py maps the JAX package's parameters onto them by name.

Under a ('data', 'space') mesh the slice axis D is split over 'space'
(`UNet3D.set_space`): each 3x3x3 conv exchanges one slice of halo with
its neighbours (parallel/halo.py), each InstanceNorm3D forms its
statistics over the whole D axis with all-reduces over 'space', and since
pooling and upsampling act on H and W only, D stays split through the
whole UNet (nn/unet3d.py:16-22 of the JAX package).
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_segmentation_torch.nn.blocks import _fan, _variance_scaling_
from multimodal_segmentation_torch.parallel.collectives import all_reduce_sum
from multimodal_segmentation_torch.parallel.halo import sharded_conv


class Conv3d(nn.Conv3d):
    """Flax nn.Conv with a cubic kernel: 'SAME' padding, stride 1, a
    he_normal or lecun_normal kernel and a zero bias. With `dtype` (Flax's
    nn.Conv(dtype=d)) it casts its input, weight and bias to d and computes
    in d; without one it computes in the promoted type of its input and its
    f32 parameters, i.e. f32. With `space` (a mesh Axis over which D is
    split) it runs as the halo-exchanged sharded conv."""

    def __init__(self, in_ch, out_ch, k, init="lecun_normal", dtype=None):
        super().__init__(in_ch, out_ch, k, padding=k // 2)
        self.init_kind = init
        self.dtype = dtype
        self.space = None

    def flax_init_(self, generator):
        kk = self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        scale, fan = _fan(self.init_kind, self.in_channels * kk, self.out_channels * kk)
        _variance_scaling_(self.weight, scale, fan, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if self.space is not None:
            return sharded_conv(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.space)
        return F.conv3d(x.to(dt), self.weight.to(dt), self.bias.to(dt), padding=self.padding)


class InstanceNorm3D(nn.Module):
    """Per-sample, per-channel norm over (D, H, W) (nn/unet3d.py:34-50):
    mean and biased variance in f32, epsilon 1e-3; the output in the
    input's dtype, in the JAX package's order ((x - mean) * rsqrt(var +
    eps), then scale, then bias, each cast to the input's dtype first).
    Not nn.InstanceNorm3d, whose epsilon is 1e-5. With `space` (a mesh
    Axis over which D is split evenly) both passes sum over the local
    slab and all-reduce the sums over the axis, differentiably."""

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.space = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        dt = x.dtype
        xf = x.float()
        if self.space is None:
            mean = xf.mean(dim=(2, 3, 4), keepdim=True)
            var = (xf - mean).square().mean(dim=(2, 3, 4), keepdim=True)
        else:
            g, n = self.space.group, xf[0, 0].numel() * self.space.size
            mean = all_reduce_sum(xf.sum(dim=(2, 3, 4), keepdim=True), g) / n
            var = all_reduce_sum((xf - mean).square().sum(dim=(2, 3, 4), keepdim=True), g) / n
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        y = y * self.weight.to(dt).view(1, -1, 1, 1, 1)
        return y + self.bias.to(dt).view(1, -1, 1, 1, 1)


class ConvBlock3D(nn.Module):
    """[Conv 3x3x3 (he_normal) -> instance norm -> relu] x 2
    (nn/unet3d.py:53-66)."""

    def __init__(self, in_ch, filters, dtype=None):
        super().__init__()
        self.Conv_0 = Conv3d(in_ch, filters, 3, init="he_normal", dtype=dtype)
        self.InstanceNorm3D_0 = InstanceNorm3D(filters)
        self.Conv_1 = Conv3d(filters, filters, 3, init="he_normal", dtype=dtype)
        self.InstanceNorm3D_1 = InstanceNorm3D(filters)

    def forward(self, x):
        x = torch.relu(self.InstanceNorm3D_0(self.Conv_0(x)))
        return torch.relu(self.InstanceNorm3D_1(self.Conv_1(x)))


def max_pool_hw(x):
    """2x2/stride-2 max pool over H and W only, D untouched
    (nn/unet3d.py:69-81), on (B, C, D, H, W): reshape + amax, so the
    gradient splits evenly across ties; floor pooling for odd H or W."""
    b, c, d, h, w = x.shape
    if h % 2 or w % 2:
        return F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
    return x.reshape(b, c, d, h // 2, 2, w // 2, 2).amax(dim=(4, 6))


def upsample2x_hw(x):
    """Nearest-neighbour 2x upsampling over H and W of (B, C, D, H, W)
    (nn/unet3d.py:84-86)."""
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


class UNet3D(nn.Module):
    """Anisotropic 3-D UNet (nn/unet3d.py:89-117): `downsample` levels of
    ConvBlock3D + max_pool_hw, a bottleneck block, then per level an H/W
    upsampling, a 3x3x3 conv, the skip concatenated after it and a block;
    a 1x1x1 conv (no dtype: f32 under bf16, as Flax promotes) and a softmax
    over the classes in f32.

    Input (B, D, H, W, in_channels), output (B, D, H, W, out_channels)
    class probabilities in f32, both channels-last."""

    def __init__(self, in_channels=3, filters=16, downsample=3, out_channels=5, dtype=None):
        super().__init__()
        self.downsample = downsample
        widths = [filters * 2 ** level for level in range(downsample + 1)]
        blocks = [(in_channels if level == 0 else widths[level - 1], widths[level])
                  for level in range(downsample + 1)]
        blocks += [(2 * widths[level], widths[level]) for level in reversed(range(downsample))]
        for i, (cin, cout) in enumerate(blocks):
            setattr(self, "ConvBlock3D_%d" % i, ConvBlock3D(cin, cout, dtype))
        for i, level in enumerate(reversed(range(downsample))):
            setattr(self, "Conv_%d" % i,
                    Conv3d(widths[level + 1], widths[level], 3, init="he_normal", dtype=dtype))
        setattr(self, "Conv_%d" % downsample, Conv3d(widths[0], out_channels, 1))

    def set_space(self, axis):
        """Split D over mesh Axis `axis` (None: not split): every conv and
        norm takes it."""
        for m in self.modules():
            if isinstance(m, (Conv3d, InstanceNorm3D)):
                m.space = axis

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        d = self.downsample
        skips = []
        for level in range(d):
            s = getattr(self, "ConvBlock3D_%d" % level)(x)
            skips.append(s)
            x = max_pool_hw(s)
        x = getattr(self, "ConvBlock3D_%d" % d)(x)
        for i, level in enumerate(reversed(range(d))):
            x = getattr(self, "Conv_%d" % i)(upsample2x_hw(x))
            x = torch.cat([x, skips[level]], dim=1)
            x = getattr(self, "ConvBlock3D_%d" % (d + 1 + i))(x)
        x = getattr(self, "Conv_%d" % d)(x)
        return torch.softmax(x.float(), dim=1).permute(0, 2, 3, 4, 1)
