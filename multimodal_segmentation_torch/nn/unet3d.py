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

`UNet3DCicek` is a second net beside it, with no JAX counterpart: the 3D
U-Net of Cicek et al., "3D U-Net: Learning Dense Volumetric Segmentation
from Sparse Annotation" (MICCAI 2016, arXiv:1606.06650, section 2 and
Fig. 1), for inference by overlap-tile (models/volumetric.py).
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_segmentation_torch.nn.blocks import BatchNorm, _fan, _variance_scaling_, conv_norm
from multimodal_segmentation_torch.ops.thin_conv import MAX_CHANNELS, thin_conv3d
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


def _thin_input(x, dt):
    """Whether a valid 3x3x3 convolution of x, computing in dt, runs as the
    thin-input convolution (ops/thin_conv.py, an implicit GEMM on the
    tensor cores): bf16 on the card, at most MAX_CHANNELS input channels
    and an even width, where cuDNN has no fast kernel (PERF.md). Not in
    float32, which has no tensor cores to reach with TF32 off, nor on the
    CPU; fp16 is no configuration's compute dtype. On the card
    `cuda_kernels.launch_counts()["thin_conv3d"]` counts the calls: 1 a
    bf16 UNet3DCicek forward (its 3-channel first convolution)."""
    return (x.is_cuda and dt == torch.bfloat16 and x.shape[1] <= MAX_CHANNELS
            and x.shape[-1] % 2 == 0)


class ValidConv3d(Conv3d):
    """A cubic Conv3d with 'VALID' padding (no padding: each side of the
    output is k - 1 shorter than the input's), or with `padding` p the
    input zero-padded by p voxels on each side first (1: Swin UNETR's
    'same' 3x3x3 convolutions). `with_bias=False` leaves out the bias, for
    conv_norm's epilogue, which adds it; a convolution whose bias was
    taken away (None) has none. A 3x3x3 one of an input that `_thin_input`
    takes runs as the thin-input convolution (of the padded input), and
    the bias is added after it as PyTorch adds cuDNN's. Any other one on
    the card takes its input in channels_last_3d, as UNet3DCicek runs
    there (a copy only where the input is not already so)."""

    def __init__(self, in_ch, out_ch, k, init="he_normal", dtype=None, padding=0):
        super().__init__(in_ch, out_ch, k, init=init, dtype=dtype)
        self.padding = (padding,) * 3

    def forward(self, x, with_bias=True):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = self.bias.to(dt) if with_bias and self.bias is not None else None
        weight = self.weight.to(dt)
        if self.kernel_size == (3, 3, 3) and _thin_input(x, dt):
            x = x.to(dt)
            if any(self.padding):
                x = F.pad(x, (self.padding[0],) * 6)
            y = thin_conv3d(x, weight)
            return y if bias is None else y + bias.view(1, -1, 1, 1, 1)
        layout = torch.channels_last_3d if x.is_cuda else torch.preserve_format
        return F.conv3d(x.to(dt, memory_format=layout), weight, bias, padding=self.padding)


class UpConv3d(nn.ConvTranspose3d):
    """2x2x2 up-convolution with stride 2 and no bias, keeping the channel
    count unless `out_channels` gives another; computes in `dtype` as
    Conv3d. Each output voxel takes one tap of each input channel, so its
    he_normal fan-in is the input channels."""

    def __init__(self, channels, dtype=None, out_channels=None):
        super().__init__(channels, out_channels or channels, 2, stride=2, bias=False)
        self.dtype = dtype

    def flax_init_(self, generator):
        scale, fan = _fan("he_normal", self.in_channels, self.out_channels)
        _variance_scaling_(self.weight, scale, fan, generator)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv_transpose3d(x.to(dt), self.weight.to(dt), None, stride=2)


class PointwiseConv3d(Conv3d):
    """A 1x1x1 Conv3d computed as what it is, a linear map of each voxel's
    channels: F.linear on the (N, D, H, W, C) view of an (N, C, D, H, W)
    input, whose (N, D, H, W, K) result is returned as its (N, K, D, H, W)
    view. Where the input is channels_last_3d both views are dense and
    nothing is transposed; cuDNN runs a float32 convolution of such an
    input as an NCDHW kernel behind a layout transform each way (PERF.md).
    Conv3d's parameters, initialiser and dtype rule; a bias taken away
    (None) adds nothing."""

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.linear(x.permute(0, 2, 3, 4, 1).to(dt), self.weight.to(dt).flatten(1), bias)
        return y.permute(0, 4, 1, 2, 3)


class BatchNorm3d(BatchNorm):
    """nn/blocks.py::BatchNorm over (N, C, D, H, W), as its (N, C, D, H*W)
    view: the same statistics (over N, D, H and W), epsilon, running
    statistics and rounding, and so the same eval-mode epilogue on the
    GPU (nn/blocks.py::conv_norm)."""

    def forward(self, x, groups=1):
        n, c, d, h, w = x.shape
        return super().forward(x.reshape(n, c, d, h * w), groups).view(x.shape)


class ValidBlock3D(nn.Module):
    """[valid 3x3x3 conv -> BatchNorm -> ReLU] x 2: in_ch -> mid -> out."""

    def __init__(self, in_ch, mid, out, dtype=None):
        super().__init__()
        self.conv_0 = ValidConv3d(in_ch, mid, 3, dtype=dtype)
        self.bn_0 = BatchNorm3d(mid)
        self.conv_1 = ValidConv3d(mid, out, 3, dtype=dtype)
        self.bn_1 = BatchNorm3d(out)

    def forward(self, x):
        return conv_norm(self.conv_1, self.bn_1, conv_norm(self.conv_0, self.bn_0, x))


def center_crop(x, size):
    """The centre (D, H, W) = `size` of (B, C, D, H, W) x, as a view."""
    lo = [(s - t) // 2 for s, t in zip(x.shape[2:], size)]
    return x[:, :, lo[0]:lo[0] + size[0], lo[1]:lo[1] + size[1], lo[2]:lo[2] + size[2]]


class UNet3DCicek(nn.Module):
    """The 3D U-Net of arXiv:1606.06650 (section 2, Fig. 1), all of whose
    convolutions are valid, so a tile's output is smaller than its input
    and depends on nothing outside it.

    Analysis path: `depth` levels and a bottom level, each two valid 3x3x3
    conv + BatchNorm + ReLU whose widths double within the level, filters
    * 2**l then twice that (32 -> 64, 64 -> 128, 128 -> 256 and at the
    bottom 256 -> 512 at the published filters=32, depth=3), then, but at
    the bottom, a 2x2x2 max pool with stride 2 on all three axes.
    Synthesis path: per level a 2x2x2 stride-2 up-convolution keeping the
    channels, the analysis level's output centre-cropped to its size and
    concatenated after it, then two conv + BatchNorm + ReLU down to the
    level's second width. Head: a 1x1x1 conv to `out_channels` classes and
    a softmax over them. Every conv but the up-convolutions has a bias:
    19,069,955 parameters at the published widths, besides the 4,672 of
    the 14 BatchNorms.

    Channels-first at its boundary: (N, in_channels, D, H, W) tiles in,
    (N, out_channels, D', H', W') f32 class probabilities out, with
    (D', H', W') = output_size((D, H, W)). Parameters and BatchNorm
    statistics stay f32; under a bf16 `dtype` every conv but the head
    computes in bf16; the head and the softmax compute in f32. BatchNorm
    uses its running statistics in eval mode, the net's only use here.

    The layout rule on the card: every activation from the first
    convolution's output to the head is channels_last_3d (NDHWC in
    memory), the layout cuDNN's sm90 convolution kernels read and write,
    so that no convolution pays a transform each way. The first
    convolution writes it (the thin-input kernel, or cuDNN on an input
    ValidConv3d makes channels_last_3d); the epilogue, the max pools, the
    up-convolutions, the crops and the concatenations keep their input's
    layout, and the head reads it as a linear map of each voxel's channels
    (PointwiseConv3d); the parameters are channels_last_3d on the card
    (models/volumetric.py::Cardiac3DSegmenter._init_cicek). The logical
    shapes, the values and the state_dict are those of the NCDHW net; on
    the CPU the net runs NCDHW."""

    def __init__(self, in_channels=3, filters=32, depth=3, out_channels=3, dtype=None):
        super().__init__()
        self.depth = depth
        widths = [filters * 2 ** level for level in range(depth + 1)]
        cin = in_channels
        for level, w in enumerate(widths):
            setattr(self, "analysis_%d" % level, ValidBlock3D(cin, w, 2 * w, dtype))
            cin = 2 * w
        for i, level in enumerate(reversed(range(depth))):
            setattr(self, "upconv_%d" % i, UpConv3d(cin, dtype))
            w = 2 * widths[level]
            setattr(self, "synthesis_%d" % i, ValidBlock3D(cin + w, w, w, dtype))
            cin = w
        self.head = PointwiseConv3d(cin, out_channels, 1, init="he_normal")

    def output_size(self, size):
        """The output's (D, H, W) of an input tile of `size`; ValueError
        where a max pool would meet an odd size or a size runs out."""
        out = []
        for s in size:
            for level in range(self.depth):
                s -= 4
                if s <= 0 or s % 2:
                    raise ValueError("tile %s: a 2x2x2 max pool meets size %d at level %d"
                                     % (tuple(size), s, level))
                s //= 2
            s -= 4
            for _ in range(self.depth):
                s = 2 * s - 4
            if s <= 0:
                raise ValueError("tile %s leaves no output" % (tuple(size),))
            out.append(s)
        return tuple(out)

    def forward(self, x):
        skips = []
        for level in range(self.depth):
            s = getattr(self, "analysis_%d" % level)(x)
            skips.append(s)
            x = F.max_pool3d(s, 2, 2)
        x = getattr(self, "analysis_%d" % self.depth)(x)
        for i, level in enumerate(reversed(range(self.depth))):
            x = getattr(self, "upconv_%d" % i)(x)
            x = torch.cat([x, center_crop(skips[level], x.shape[2:])], dim=1)
            x = getattr(self, "synthesis_%d" % i)(x)
        return torch.softmax(self.head(x).float(), dim=1)
