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
from torch.utils.checkpoint import checkpoint

from multimodal_segmentation_torch.ops.epilogue import bn_epilogue
from multimodal_segmentation_torch.parallel.collectives import mean_over, whole_weight

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
    kernels, zero bias (or none, as use_bias=False). Under tensor
    parallelism the weight holds this rank's out channels and the forward
    gathers the whole (parallel/collectives.py::whole_weight)."""

    def __init__(self, in_ch, out_ch, k, padding="SAME", init="lecun_normal", stride=1,
                 bias=True):
        if padding == "SAME" and stride != 1:
            raise ValueError("SAME padding is ported for stride 1 only")
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=k // 2 if padding == "SAME" else 0, bias=bias)
        self.init_kind = init

    def flax_init_(self, generator):
        kk = self.kernel_size[0] * self.kernel_size[1]
        scale, fan = _fan(self.init_kind, self.in_channels * kk, self.out_channels * kk)
        _variance_scaling_(self.weight, scale, fan, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, with_bias=True):
        bias = None if self.bias is None or not with_bias else self.bias.to(x.dtype)
        return F.conv2d(x, whole_weight(self.weight).to(x.dtype), bias,
                        stride=self.stride, padding=self.padding)


class Linear(nn.Linear):
    """Flax nn.Dense counterpart (lecun_normal, he_normal or zero kernel,
    zero bias). As nn.Dense(dtype=d), a Linear with `dtype` casts its
    input, weight and bias to d and computes in d; without one it computes
    in the promoted type of its input and its f32 parameters, i.e. f32.
    Tensor parallelism as Conv2d's."""

    def __init__(self, in_features, out_features, init="lecun_normal", dtype=None):
        super().__init__(in_features, out_features)
        self.init_kind = init
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), whole_weight(self.weight).to(dt), self.bias.to(dt))

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
    variance and knows no groups, so it is not used; nor is
    nn.SyncBatchNorm, which keeps one too.

    Data parallelism: with `group` (the mesh's 'data' process group, set
    by the model's set_mesh) the train-mode moments are those of the
    global batch, as GSPMD makes them in the JAX package: each rank's
    per-group (G, C) mean and E[x^2] are averaged over the group with a
    differentiable all-reduce (parallel/collectives.py), then the biased
    variance is formed from them. Every rank holds the same number of
    rows (shard_batch), so the mean of the ranks' moments is the global
    one, and over one rank it is the rank's own, bit for bit. Without a
    group nothing changes.

    Rematerialisation (`remat`): inside a block that `remat` runs, the
    forward is computed twice, once in the forward pass and once again in
    the backward. The running statistics must move once, as Flax's
    nn.remat updates batch_stats once: `remat` sets `deferred` to a list
    for the first pass, into which the moments go instead, and applies
    them after it; during the recomputation `deferred` is () and the
    moments are dropped.
    """

    momentum = 0.99

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.group = None
        self.deferred = None
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
            sq = xf.square().mean(dim=(0, 3, 4))
            if self.group is not None:
                mean, sq = mean_over(torch.stack([mean, sq]), self.group)
            var = torch.maximum(sq - mean.square(), torch.zeros((), device=x.device))
            if self.deferred is None:
                self.update_running(mean, var)
            elif isinstance(self.deferred, list):
                self.deferred.append((self, mean.detach(), var.detach()))
        shape = (1, groups, c, 1, 1)
        mul = torch.rsqrt(var.to(dt).view(shape) + self.eps) * self.weight.to(dt).view(1, 1, c, 1, 1)
        y = (xg - mean.to(dt).view(shape)) * mul + self.bias.to(dt).view(1, 1, c, 1, 1)
        return y.reshape(x.shape)

    @torch.no_grad()
    def update_running(self, mean, var):
        """The EMA of the running statistics from a call's (G, C) moments."""
        m = self.momentum
        self.running_mean.mul_(m).add_((1 - m) * mean.mean(0))
        self.running_var.mul_(m).add_((1 - m) * var.mean(0))


def remat(module, body, *args):
    """body(*args), the forward of `module`, rematerialised: under
    torch.utils.checkpoint (non-reentrant), which saves only the inputs and
    recomputes the body in the backward. Values and gradients are those of
    body(*args); peak memory is lower. The running statistics of the
    module's BatchNorms move once (BatchNorm.deferred)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    moments = []
    for m in norms:
        m.deferred = moments
    try:
        out = checkpoint(body, *args, use_reentrant=False)
    finally:
        for m in norms:
            m.deferred = ()
    for m, mean, var in moments:
        m.update_running(mean, var)
    return out


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H and W (nn/blocks.py:
    135-165; keras_contrib InstanceNormalization). Mean and biased variance
    in f32, epsilon 1e-3; the output in the input's dtype, in the JAX
    package's order ((x - mean) * rsqrt(var + eps), then scale, then bias).
    `groups` is accepted for the Norm interface and ignored: the statistics
    are per sample."""

    def __init__(self, channels, eps=1e-3, use_scale=True, use_bias=True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None

    def forward(self, x, groups=1):
        dt = x.dtype
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
        if self.weight is not None:
            y = y * self.weight.to(dt).view(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(1, -1, 1, 1)
        return y


def _on_card(x):
    """Whether x is on the GPU, where conv_norm's kernel runs (a test
    substitutes this to exercise the decision on the CPU)."""
    return x.is_cuda


def conv_norm(conv, norm, x, groups=1, relu=True):
    """relu?(norm(conv(x), groups)): a Conv2d with a bias, its norm and an
    optional ReLU; or, on (N, C, D, H, W) volumes, a convolution of
    nn/unet3d.py with its BatchNorm3d (a BatchNorm on the (N, C, D, H*W)
    view).

    On the GPU a BatchNorm in eval mode runs with its convolution's bias
    and the ReLU as one pass over the bias-free convolution's output: the
    eval-mode conv epilogue (ops/epilogue.py::bn_epilogue; a 5-D output
    as its (N, C, D, H*W) view, the same kernel), which rounds
    as the separate operations do, so the output is the same bit for bit,
    and which has a backward. Every other case runs the operations one by
    one: train mode (batch statistics are a reduction, not an affine),
    InstanceNorm or no norm, and the CPU. The device and the mode decide;
    no flag does. The epilogue calls neither the norm nor F.relu, so a
    forward hook on the norm (the debug_nans guard's) does not run there:
    the next module's hook (the next convolution's or the enclosing
    block's) sees the result."""
    if _on_card(x) and isinstance(norm, BatchNorm) and not norm.training:
        return bn_epilogue(conv(x, with_bias=False), conv.bias, norm.running_mean,
                           norm.running_var, norm.weight, norm.bias, norm.eps, relu)
    y = norm(conv(x), groups)
    return F.relu(y) if relu else y


class _NoNorm(nn.Module):
    """normalise='none': the input as it is."""

    def forward(self, x, groups=1):
        return x


def _norm(kind, channels):
    """Normalisation by name (utils/model_utils.py:6-13; nn/blocks.py:
    169-190): 'batch', 'instance' or anything else for none. Every preset
    uses 'batch'."""
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "instance":
        return InstanceNorm(channels)
    return _NoNorm()


def leaky_relu(x, alpha=0.3):
    """Keras LeakyReLU, default slope 0.3. Written as jax.nn.leaky_relu is,
    where(x >= 0, x, alpha * x), so that the gradient at exactly 0 is 1 as
    in the JAX package (F.leaky_relu gives alpha there; exact zeros are
    common, e.g. a conv over an empty anatomy region)."""
    return torch.where(x >= 0, x, alpha * x)


class ConvBlock(nn.Module):
    """[Conv3x3(he_normal) -> norm -> relu] x 2 (models/unet.py:94-101).
    With `remat`, in train mode the block is rematerialised (`remat`):
    its intermediates are recomputed in the backward (nn/blocks.py:
    193-225 of the JAX package)."""

    def __init__(self, in_ch, filters, norm="batch", remat=False):
        super().__init__()
        self.remat = remat
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = _norm(norm, filters)
        self.Conv_1 = Conv2d(filters, filters, 3, init="he_normal")
        self.Norm_1 = _norm(norm, filters)

    def _body(self, x, groups):
        x = conv_norm(self.Conv_0, self.Norm_0, x, groups)
        return conv_norm(self.Conv_1, self.Norm_1, x, groups)

    def forward(self, x, groups=1):
        if self.remat and self.training:
            return remat(self, self._body, x, groups)
        return self._body(x, groups)


def upsample2x(x):
    """Nearest-neighbour 2x upsampling (Keras UpSampling2D)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class UpsampleBlock(nn.Module):
    """Upsample2x -> Conv3x3 -> norm (utils/model_utils.py:15-24) with the
    'linear' activation, the only one its caller (UNetUp) uses; `remat` as
    ConvBlock's (nn/blocks.py:235-259 of the JAX package)."""

    def __init__(self, in_ch, filters, norm="batch", remat=False):
        super().__init__()
        self.remat = remat
        self.Conv_0 = Conv2d(in_ch, filters, 3, init="he_normal")
        self.Norm_0 = _norm(norm, filters)

    def _body(self, x, groups):
        return conv_norm(self.Conv_0, self.Norm_0, upsample2x(x), groups, relu=False)

    def forward(self, x, groups=1):
        if self.remat and self.training:
            return remat(self, self._body, x, groups)
        return self._body(x, groups)


def max_pool2(x):
    """2x2/stride-2 max pooling as reshape + amax; floor pooling for odd
    sizes (nn/blocks.py:263-278)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        return F.max_pool2d(x, 2, 2)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
