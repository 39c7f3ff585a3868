"""The models' components in plain PyTorch, float32, NCHW.

A frozen copy of the port's nn/ modules (blocks, UNet halves, anatomy
encoders, balancer, FiLM decoder, spectral-norm discriminator, LocNet and
fuser, modality encoder, segmentor) with the same submodule names, so a
state_dict of one loads into the other. What the copy leaves out: data and
tensor parallelism, rematerialisation, the SPADE decoder, and the kernels:
the anatomy rounding is torch.round and the warp is warp.tps_warp. Every
module that the program runs in its compute dtype has `compute = True`
and rounds its operands with `q` (precision.py; exact by default).
"""

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import warp
from benchmark.reference.precision import exact


def interleave(xs):
    """Batch-axis concatenation in sample-major order: row b*K + k is
    variant k of sample b."""
    if len(xs) == 1:
        return xs[0]
    y = torch.stack(xs, dim=1)
    return y.reshape((xs[0].shape[0] * len(xs),) + tuple(xs[0].shape[1:]))


def deinterleave(y, K):
    if K == 1:
        return [y]
    yr = y.reshape((y.shape[0] // K, K) + tuple(y.shape[1:]))
    return [yr[:, k] for k in range(K)]


def leaky_relu(x, alpha=0.3, q=exact):
    """where(x >= 0, x, alpha x): gradient 1 at 0, as the models define it;
    the result rounded by `q` where the program holds it in its compute
    dtype."""
    return q(torch.where(x >= 0, x, alpha * x))


class Compute(nn.Module):
    """A module that the program runs in its compute dtype: `q` rounds the
    values it holds (precision.py; exact by default)."""

    compute = True
    q = staticmethod(exact)


class Conv2d(nn.Conv2d):
    """'SAME' (stride 1, pad k//2) or 'VALID' convolution; `init` is the
    variance scaling that traffic/weights.py draws the kernel with. With
    `compute`, its operands and output are rounded by `q`."""

    q = staticmethod(exact)

    def __init__(self, in_ch, out_ch, k, padding="SAME", init="lecun_normal", stride=1,
                 bias=True, compute=True):
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=k // 2 if padding == "SAME" else 0, bias=bias)
        self.init_kind = init
        self.compute = compute

    def forward(self, x):
        q = self.q
        return q(F.conv2d(q(x), q(self.weight), self.bias, stride=self.stride,
                          padding=self.padding))


class Linear(nn.Linear):
    """Dense layer; `compute` where the program runs it in its compute
    dtype (a Dense given a dtype), else float32 in the program too."""

    q = staticmethod(exact)

    def __init__(self, in_features, out_features, init="lecun_normal", compute=False):
        super().__init__(in_features, out_features)
        self.init_kind = init
        self.compute = compute

    def forward(self, x):
        q = self.q
        return q(F.linear(q(x), q(self.weight), self.bias))


class BatchNorm(Compute):
    """Keras BatchNorm (momentum 0.99, eps 1e-3) with per-group batch
    statistics in train mode: row b*G + g belongs to group g; biased
    variance max(E[x^2] - mean^2, 0); the running statistics move once a
    call by the mean of the group moments."""

    momentum = 0.99

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, groups=1):
        n, c = x.shape[:2]
        if not self.training:
            groups = 1
            mean, var = self.running_mean[None], self.running_var[None]
        xg = x.reshape((n // groups, groups) + tuple(x.shape[1:]))
        if self.training:
            mean = xg.mean(dim=(0, 3, 4))
            sq = xg.square().mean(dim=(0, 3, 4))
            var = torch.clamp(sq - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.mean(0))
                self.running_var.mul_(m).add_((1 - m) * var.mean(0))
        q = self.q
        shape = (1, groups, c, 1, 1)
        mul = q(torch.rsqrt(var.view(shape) + self.eps) * self.weight.view(1, 1, c, 1, 1))
        y = q(q(q(xg - q(mean.view(shape))) * mul) + q(self.bias.view(1, 1, c, 1, 1)))
        return y.reshape(x.shape)


def max_pool2(x):
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


class ConvBlock(nn.Module):
    def __init__(self, in_ch, filters):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = BatchNorm(filters)
        self.Conv_1 = Conv2d(filters, filters, 3, init="he_normal")
        self.Norm_1 = BatchNorm(filters)

    def forward(self, x, groups=1):
        x = F.relu(self.Norm_0(self.Conv_0(x), groups))
        return F.relu(self.Norm_1(self.Conv_1(x), groups))


class UpsampleBlock(nn.Module):
    def __init__(self, in_ch, filters):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = BatchNorm(filters)

    def forward(self, x, groups=1):
        return self.Norm_0(self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest")), groups)


class UNetDown(nn.Module):
    def __init__(self, in_ch, filters, downsample):
        super().__init__()
        self.downsample = downsample
        for level in range(downsample):
            f = filters * 2 ** level
            self.add_module("ConvBlock_%d" % level, ConvBlock(in_ch, f))
            in_ch = f

    def forward(self, x, groups=1):
        skips = []
        for level in range(self.downsample):
            s = getattr(self, "ConvBlock_%d" % level)(x, groups)
            skips.append(s)
            x = max_pool2(s)
        return x, skips


class UNetBottleneck(nn.Module):
    def __init__(self, filters, downsample):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(filters * 2 ** (downsample - 1), filters * 2 ** downsample)

    def forward(self, x, groups=1):
        return self.ConvBlock_0(x, groups)


class UNetUp(nn.Module):
    def __init__(self, filters, downsample):
        super().__init__()
        self.downsample = downsample
        in_ch = filters * 2 ** downsample
        for i, level in enumerate(reversed(range(downsample))):
            f = filters * 2 ** level
            self.add_module("UpsampleBlock_%d" % i, UpsampleBlock(in_ch, f))
            self.add_module("ConvBlock_%d" % i, ConvBlock(2 * f, f))
            in_ch = f

    def forward(self, x, skips, groups=1):
        for i, level in enumerate(reversed(range(self.downsample))):
            x = getattr(self, "UpsampleBlock_%d" % i)(x, groups)
            x = getattr(self, "ConvBlock_%d" % i)(torch.cat([x, skips[level]], dim=1), groups)
        return x


class AnatomyHead(Compute):
    """The softmax of the anatomy logits, then rounding half to even with
    a straight-through gradient."""

    def forward(self, logits):
        s = self.q(torch.softmax(logits, dim=1))
        return s + (torch.round(s) - s).detach()


class AnatomyEncoder(nn.Module):
    """MMSDNet's single-modality anatomy encoder."""

    def __init__(self, filters, downsample, out_channels):
        super().__init__()
        self.UNetDown_0 = UNetDown(1, filters, downsample)
        self.UNetBottleneck_0 = UNetBottleneck(filters, downsample)
        self.UNetUp_0 = UNetUp(filters, downsample)
        self.conv_anatomy = Conv2d(filters, out_channels, 1)
        self.head = AnatomyHead()

    def forward(self, x):
        x, skips = self.UNetDown_0(x)
        return self.head(self.conv_anatomy(self.UNetUp_0(self.UNetBottleneck_0(x), skips)))


class DualAnatomyEncoder(nn.Module):
    """DAFNet's encoder: private down paths, shared bottleneck, up path and
    head; per-(pair, modality) statistics on the shared path."""

    def __init__(self, filters, downsample, out_channels):
        super().__init__()
        self.down1 = UNetDown(1, filters, downsample)
        self.down2 = UNetDown(1, filters, downsample)
        self.shared_bottleneck = UNetBottleneck(filters, downsample)
        self.shared_up = UNetUp(filters, downsample)
        self.conv_anatomy = Conv2d(filters, out_channels, 1)
        self.head = AnatomyHead()

    def forward(self, x1, x2, pair_groups=1):
        h1, skips1 = self.down1(x1, pair_groups)
        h2, skips2 = self.down2(x2, pair_groups)
        h = interleave([h1, h2])
        skips = [interleave([a, b]) for a, b in zip(skips1, skips2)]
        g = 2 * pair_groups
        h = self.shared_up(self.shared_bottleneck(h, g), skips, g)
        return deinterleave(self.head(self.conv_anatomy(h)), 2)


class Balancer(nn.Module):
    def __init__(self, n_pairs):
        super().__init__()
        self.Dense_0 = Linear(n_pairs, 5)
        self.beta = Linear(5, n_pairs)

    def forward(self, s_target, s_candidates):
        def overlap(a, b, smooth=1e-12):
            inter = torch.sum(a * b, dim=(1, 2, 3))
            union = torch.sum(a, dim=(1, 2, 3)) + torch.sum(b, dim=(1, 2, 3))
            return ((2.0 * inter + smooth) / (union + smooth))[:, None]
        x = torch.cat([overlap(s_target, s) for s in s_candidates], dim=-1)
        return torch.softmax(self.beta(F.relu(self.Dense_0(x))), dim=-1)


class FiLMLayer(Compute):
    def __init__(self, num_z):
        super().__init__()
        self.Conv_0 = Conv2d(8, 8, 3)
        self.Conv_1 = Conv2d(8, 8, 3)
        self.Dense_0 = Linear(num_z, 8, compute=True)
        self.Dense_1 = Linear(num_z, 8, compute=True)

    def forward(self, h, z):
        q = self.q
        l1 = leaky_relu(self.Conv_0(h), q=q)
        l2 = self.Conv_1(l1)
        gamma = leaky_relu(self.Dense_0(z), q=q)
        beta = leaky_relu(self.Dense_1(z), q=q)
        mod = q(q(l2 * gamma[:, :, None, None]) + beta[:, :, None, None])
        return q(l1 + leaky_relu(mod, q=q))


class FiLMDecoder(Compute):
    def __init__(self, in_ch, num_z):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, 8, 3)
        for i in range(4):
            self.add_module("FiLMLayer_%d" % i, FiLMLayer(num_z))
        # the program runs the last 1x1 conv in float32
        self.Conv_1 = Conv2d(8, 1, 1, init="glorot_normal", compute=False)

    def forward(self, s, z):
        h = leaky_relu(self.Conv_0(s), q=self.q)
        for i in range(4):
            h = getattr(self, "FiLMLayer_%d" % i)(h, z)
        return torch.tanh(self.Conv_1(h))


class Decoder(nn.Module):
    def __init__(self, decoder_type, in_ch, num_z):
        super().__init__()
        if decoder_type != "film":
            raise ValueError("the reference has the FiLM decoder only, not %r" % decoder_type)
        self.FiLMDecoder_0 = FiLMDecoder(in_ch, num_z)

    def forward(self, s, z):
        return self.FiLMDecoder_0(s, z)


def _valid_hw(n, k, stride):
    return (n - k) // stride + 1


class SpectralConv(Conv2d):
    """VALID 4x4 conv whose kernel carries the spectral penalty: 3 power
    iterations from the stored `u` (HWIO flattening), penalty alpha *
    mean(|stop_grad(x / sigma) - x|)."""

    def __init__(self, in_ch, features, stride=2, alpha=10.0):
        super().__init__(in_ch, features, 4, padding="VALID", init="he_normal", stride=stride)
        self.alpha = alpha
        self.register_buffer("u", torch.empty(16 * in_ch, 1))

    def penalty(self, iters=3, eps=1e-12):
        x = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
        u = self.u.detach()
        for _ in range(iters):
            wtu = x.T @ u
            v = wtu / torch.sqrt(torch.sum(wtu.square()) + eps)
            wv = x @ v
            u = wv / torch.sqrt(torch.sum(wv.square()) + eps)
        sigma = (u.T @ x @ v)[0, 0]
        self.u.copy_(u.detach())
        return self.alpha * torch.mean(torch.abs((x / sigma).detach() - x))


class Discriminator(Compute):
    def __init__(self, in_ch, input_hw, filters, downsample_blocks):
        super().__init__()
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
        x = leaky_relu(self.Conv_0(x), 0.2, self.q)
        for conv in self.spectral_convs():
            x = leaky_relu(conv(x), 0.2, self.q)
        out = self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        if not collect_spectral:
            return out, None
        return out, sum(conv.penalty() for conv in self.spectral_convs())


def _locnet_hw(n):
    return ((n - 4) // 2 - 4) // 2 - 4


class LocNet(Compute):
    def __init__(self, in_ch, input_hw, cp_points=25):
        super().__init__()
        self.cp_points = cp_points
        self.Conv_0 = Conv2d(in_ch, 20, 5, padding="VALID")
        self.Conv_1 = Conv2d(20, 20, 5, padding="VALID")
        self.Conv_2 = Conv2d(20, 20, 5, padding="VALID")
        self.Dense_0 = Linear(20 * _locnet_hw(input_hw[0]) * _locnet_hw(input_hw[1]), 100)
        self.Dense_1 = Linear(100, cp_points * 2, init="zeros")

    def forward(self, s1, s2):
        x = torch.cat([s1, s2], dim=1)
        x = max_pool2(leaky_relu(self.Conv_0(x), q=self.q))
        x = max_pool2(leaky_relu(self.Conv_1(x), q=self.q))
        x = leaky_relu(self.Conv_2(x), q=self.q)
        x = torch.tanh(self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))
        return self.Dense_1(x).reshape(-1, self.cp_points, 2)


class AnatomyFuser(Compute):
    """s1 warped into s2's space by the LocNet's thin-plate spline, and the
    pixelwise max with s2."""

    def __init__(self, in_ch, input_hw):
        super().__init__()
        self.locnet = LocNet(2 * in_ch, input_hw)

    def forward(self, s1, s2):
        theta = self.locnet(s1, s2)
        s1_def = self.q(warp.tps_warp(s1.permute(0, 2, 3, 1), theta).permute(0, 3, 1, 2))
        return s1_def, torch.maximum(s1_def, s2)


class ModalityEncoder(Compute):
    def __init__(self, in_ch, input_hw, num_z=8):
        super().__init__()
        h, w = input_hw
        for i, f in enumerate((16, 32, 64, 128)):
            self.add_module("Conv_%d" % i, Conv2d(in_ch, f, 3, padding="VALID",
                                                 init="he_normal", stride=2))
            in_ch, h, w = f, (h - 3) // 2 + 1, (w - 3) // 2 + 1
        self.Dense_0 = Linear(h * w * in_ch, 32, init="he_normal", compute=True)
        self.z_mean = Linear(32, num_z)
        self.z_log_var = Linear(32, num_z)

    def forward(self, anatomy, image, eps=None):
        x = torch.cat([anatomy, image], dim=1)
        for i in range(4):
            x = leaky_relu(getattr(self, "Conv_%d" % i)(x), q=self.q)
        x = leaky_relu(self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)), q=self.q)
        z_mean = self.z_mean(x)
        z_log_var = self.z_log_var(x)
        z = z_mean if eps is None else z_mean + torch.exp(0.5 * z_log_var) * eps
        kl = -0.5 * torch.sum(1.0 + z_log_var - z_mean.square() - torch.exp(z_log_var), dim=-1)
        return z, z_mean, z_log_var, kl[:, None]


class Segmentor(nn.Module):
    def __init__(self, in_ch, num_masks):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, 64, 3, init="he_normal")
        self.BatchNorm_0 = BatchNorm(64)
        self.Conv_1 = Conv2d(64, 64, 3, init="he_normal")
        self.BatchNorm_1 = BatchNorm(64)
        self.Conv_2 = Conv2d(64, num_masks + 1, 1)

    def forward(self, s, groups=1):
        x = F.relu(self.BatchNorm_0(self.Conv_0(s), groups))
        x = F.relu(self.BatchNorm_1(self.Conv_1(x), groups))
        return torch.softmax(self.Conv_2(x), dim=1)
