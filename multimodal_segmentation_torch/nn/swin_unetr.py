"""Swin UNETR: Hatamizadeh, Nath, Tang, Yang, Roth and Xu, "Swin UNETR:
Swin Transformers for Semantic Segmentation of Brain Tumors in MRI
Images" (arXiv:2201.01266), as MONAI builds it
(monai/networks/nets/swin_unetr.py, SwinUNETR with normalize=True,
norm_name="instance", downsample="mergingv2"), for inference.

Shapes are (B, C, D, H, W) at the boundary; inside the Swin encoder the
tokens are channels-last (B, D, H, W, C).

  Swin encoder (`swinViT`). A 2x2x2 stride-2 patch embedding with a bias
  (computed as a linear map of each patch's 8 * C voxels), then four
  stages of two Swin blocks at width C = feature_size * 2**i with 3 * 2**i
  heads of C / (3 * 2**i) channels, each stage ending in patch merging to
  2C at half the resolution: the 8 voxels of each 2x2x2 block in
  itertools.product((0, 1), repeat=3) order, LayerNorm(8C), Linear(8C ->
  2C) without a bias (MONAI's PatchMergingV2). The hidden states x0 (the
  embedding) and x1-x4 (the stages' outputs) are each passed through a
  LayerNorm over C without affine parameters.
  A Swin block: x = x + A(LN1(x)), then x = x + MLP(LN2(x)), the MLP
  Linear(C -> 4C), exact GELU, Linear(4C -> C). A(.): the normed tokens
  zero-padded on each axis to a multiple of the window (7), in odd blocks
  rolled by -3 on each axis, cut into 7^3-token windows, multi-head
  attention inside each window with a learned relative-position bias
  (a (13^3, heads) table indexed by (dd + 6) * 169 + (dh + 6) * 13 + (dw +
  6)) and, in rolled blocks, -100 between tokens of different shift
  regions (MONAI's compute_mask on the padded grid), then projected,
  the windows, the roll and the padding undone. Padded tokens take part
  in attention unmasked, as in MONAI. An axis no longer than the window
  takes its size as the window and is not rolled (MONAI's
  get_window_size); the bias is then read at the first n x n entries of
  the 7^3 window's index, as MONAI reads it.
  Convolutional encoders and decoder. UnetResBlock(cin -> cout): 3^3
  conv, InstanceNorm, LeakyReLU(0.01), 3^3 conv, InstanceNorm, plus the
  input (or its 1^3 conv and InstanceNorm where cin != cout), LeakyReLU.
  No convolution has a bias; InstanceNorm has no affine parameters and
  no running statistics (eps 1e-5). enc0 = Res(in -> F) on the input,
  enc1-enc3 = Res on x0', x1', x2' at their widths, dec4 = Res(16F) on
  x4'; five up blocks, each a 2x2x2 stride-2 transposed convolution
  without a bias, the skip concatenated after it, and Res(2 cout ->
  cout); the head a 1^3 conv F -> out_channels with a bias. The output is
  logits.

Precision: parameters stay float32; under a bf16 `dtype` every
activation is bf16 and every linear map and convolution computes in bf16
(float32 sums); LayerNorm and InstanceNorm take their statistics in
float32, the attention's softmax is float32, and the head computes in
float32 on the bf16 features.

InstanceNorm's statistics are a window's own, so the convolutional
encoders and decoder run one window at a time: each InstanceNorm is then
the batch norm of a batch of one (F.batch_norm with batch statistics),
which reads and writes any layout. On the card every activation of that
path is channels_last_3d (the Swin encoder's hidden states are
channels-last views already) and the 5-D parameters are made so
(models/volumetric.py), so no convolution pays a layout transform. The
convolutions are the 3D U-Net's modules (nn/unet3d.py): ValidConv3d of
the input zero-padded by one voxel for the 3^3 ones, so that enc0's
first, of the 4-channel input, runs as the thin-input kernel
(ops/thin_conv.py) where _thin_input takes it, and the seven with 48
output channels (encoder1's second, encoder2's, decoder2's and
decoder1's) as the same-convolution kernel (ops/same_conv.py) where
_same_c48 takes them; UpConv3d for the transposed ones; PointwiseConv3d
for the 1^3 ones and the head.

Window attention runs through F.scaled_dot_product_attention, on the
card its memory-efficient kernel (softmax in float32), the bias and mask
one bf16 operand: a 4-window forward took 109 ms on an H100 against 173
ms with plain matmuls and a float32 softmax over materialised scores
(PERF.md).

While a torch.profiler session runs, each block's attention half, from
LN1 to the crop, records a `predict3d.attention` span and each
UnetResBlock a `predict3d.resblock` span (utils/tracing.py).

Parameter names follow MONAI's SwinUNETR, so its state_dict's keys are
these (its relative_position_index buffers aside).
"""

import contextlib
import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_segmentation_torch.nn.blocks import _variance_scaling_
from multimodal_segmentation_torch.nn.unet3d import PointwiseConv3d, UpConv3d, ValidConv3d
from multimodal_segmentation_torch.utils import tracing

WINDOW = 7
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
MLP_RATIO = 4
SLOPE = 0.01
EPS = 1e-5
# the attention bias's last dimension is allocated to a multiple of this,
# so that the memory-efficient kernel reads it without a padded copy
_ALIGN = 16


def window_and_shift(size, window=WINDOW):
    """MONAI's get_window_size: (window, shift) per axis of a (D, H, W)
    `size`; an axis no longer than the window takes its size as the window
    and no shift."""
    ws = tuple(s if s <= window else window for s in size)
    shift = tuple(0 if s <= window else window // 2 for s in size)
    return ws, shift


def relative_position_index(window=WINDOW):
    """(window^3, window^3) index into the relative-position table: (dd +
    w - 1) * (2w - 1)^2 + (dh + w - 1) * (2w - 1) + (dw + w - 1)."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    span = 2 * window - 1
    return rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]


def partition(x, ws):
    """(B, D, H, W, C) -> (B * windows, ws^3, C), windows in (b, d, h, w)
    order (MONAI's window_partition)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def reverse(windows, ws, dims):
    """The inverse of partition: (B * windows, ws^3, C) -> (B, D, H, W, C)."""
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(dims, ws, shift, device):
    """(windows, n, n) float32: 0 between tokens of one shift region, -100
    between tokens of different ones, on the padded grid `dims` (MONAI's
    compute_mask)."""
    img = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    regions = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, shift)]
    for d, h, w in itertools.product(*regions):
        img[:, d, h, w, :] = cnt
        cnt += 1
    win = partition(img, ws).squeeze(-1)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return torch.where(diff != 0, -100.0, 0.0)


def _linear(x, m, dt):
    return F.linear(x, m.weight.to(dt), None if m.bias is None else m.bias.to(dt))


def _layer_norm(x, m, dt):
    return F.layer_norm(x, m.normalized_shape, m.weight.to(dt), m.bias.to(dt), m.eps)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with the
    relative-position bias (MONAI's WindowAttention; no dropout)."""

    def __init__(self, dim, heads, window=WINDOW):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        span = 2 * window - 1
        self.relative_position_bias_table = nn.Parameter(torch.zeros(span ** 3, heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self, n):
        """(heads, n, n) float32: the table read at the first n x n entries
        of the window's index, as MONAI reads it."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[idx].view(n, n, -1).permute(2, 0, 1)

    def forward(self, x, mask, dt):
        """x: (B * windows, n, C) in dt; mask: None or (windows, n, n)."""
        bw, n, c = x.shape
        h = self.heads
        q, k, v = _linear(x, self.qkv, dt).view(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        bias = self.bias(n)
        groups = 1 if mask is None else mask.shape[0]
        # the bias (and mask) as one dt operand whose rows are aligned
        full = torch.empty((groups, h, n, -(-n // _ALIGN) * _ALIGN), dtype=dt, device=x.device)
        full[..., :n].copy_(bias[None] if mask is None else bias[None] + mask[:, None])
        full = full[..., :n]
        with _sdpa_backend(q):
            if mask is None:
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=full, scale=self.scale)
            else:
                # one call a window of the batch, so that the mask's windows
                # line up with the batch's
                o = torch.cat([F.scaled_dot_product_attention(
                    q[i:i + groups], k[i:i + groups], v[i:i + groups], attn_mask=full,
                    scale=self.scale) for i in range(0, bw, groups)])
        return _linear(o.transpose(1, 2).reshape(bw, n, c), self.proj, dt)


def _sdpa_backend(q):
    """On the card the memory-efficient kernel, which takes an additive
    bias and whose name the benchmark files under matmul (a cuDNN kernel
    would be filed under convolution); elsewhere PyTorch's choice."""
    if not q.is_cuda:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)


class MLPBlock(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x, dt):
        return _linear(F.gelu(_linear(x, self.linear1, dt)), self.linear2, dt)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, heads, shifted):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, MLP_RATIO * dim)

    def forward(self, x, mask, dt):
        """x: (B, D, H, W, C) in dt; mask: the stage's shift mask or None."""
        b, d, h, w, c = x.shape
        ws, shift = window_and_shift((d, h, w))
        rolled = self.shifted and any(shift)
        with tracing.span("predict3d.attention"):
            y = _layer_norm(x, self.norm1, dt)
            pad = [(-s) % n for s, n in zip((d, h, w), ws)]
            if any(pad):
                y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
            dims = (b, d + pad[0], h + pad[1], w + pad[2])
            if rolled:
                y = torch.roll(y, [-s for s in shift], (1, 2, 3))
            y = self.attn(partition(y, ws), mask if rolled else None, dt)
            y = reverse(y, ws, dims)
            if rolled:
                y = torch.roll(y, list(shift), (1, 2, 3))
            y = y[:, :d, :h, :w]
        x = x + y
        return x + self.mlp(_layer_norm(x, self.norm2, dt), dt)


class PatchMergingV2(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x, dt):
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)],
                      -1)
        return _linear(_layer_norm(x, self.norm, dt), self.reduction, dt)


class BasicLayer(nn.Module):
    """A stage: its Swin blocks (unrolled, rolled, ...), then merging."""

    def __init__(self, dim, depth, heads):
        super().__init__()
        self.blocks = nn.ModuleList(SwinTransformerBlock(dim, heads, i % 2 == 1)
                                    for i in range(depth))
        self.downsample = PatchMergingV2(dim)
        self._masks = {}

    def mask(self, size, device):
        ws, shift = window_and_shift(size)
        if not any(shift):
            return None
        dims = tuple(-(-s // w) * w for s, w in zip(size, ws))
        key = (dims, ws, shift, str(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(dims, ws, shift, device)
        return self._masks[key]

    def forward(self, x, dt):
        mask = self.mask(tuple(x.shape[1:4]), x.device)
        for blk in self.blocks:
            x = blk(x, mask, dt)
        return self.downsample(x, dt)


class PatchEmbed(nn.Module):
    """Conv3d(in -> dim, kernel 2, stride 2, with a bias) as a linear map of
    each 2x2x2 patch's in * 8 values, giving (B, D/2, H/2, W/2, dim)."""

    def __init__(self, in_channels, dim):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, dim, 2, stride=2)

    def forward(self, x, dt):
        b, c, d, h, w = x.shape
        p = x.to(dt).view(b, c, d // 2, 2, h // 2, 2, w // 2, 2).permute(0, 2, 4, 6, 1, 3, 5, 7)
        return F.linear(p.reshape(b, d // 2, h // 2, w // 2, c * 8),
                        self.proj.weight.to(dt).flatten(1), self.proj.bias.to(dt))


class SwinTransformer(nn.Module):
    def __init__(self, in_channels, dim):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, dim)
        for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
            setattr(self, "layers%d" % (i + 1),
                    nn.ModuleList([BasicLayer(dim * 2 ** i, depth, heads)]))

    def forward(self, x, dt):
        """The normed hidden states x0'-x4', each (B, C, D, H, W) as a
        channels_last_3d view of the (B, D, H, W, C) tokens."""
        x = self.patch_embed(x, dt)
        out = [x]
        for i in range(len(DEPTHS)):
            x = getattr(self, "layers%d" % (i + 1))[0](x, dt)
            out.append(x)
        return [F.layer_norm(t, t.shape[-1:], eps=EPS).permute(0, 4, 1, 2, 3) for t in out]


class _Convolution(nn.Module):
    """MONAI's Convolution: the convolution under `conv`, its bias taken
    away unless `bias`."""

    def __init__(self, conv, bias=False):
        super().__init__()
        if not bias:
            conv.register_parameter("bias", None)
        self.conv = conv


def _norm(x):
    """InstanceNorm3d without affine parameters of a (1, C, D, H, W)
    window: its batch norm, statistics in float32, in x's layout on the
    card (the CPU's channels-last batch norm sums in one pass, 2.7e-5 off
    at 64^3, so the CPU reads NCDHW)."""
    if not x.is_cuda:
        x = x.contiguous()
    return F.batch_norm(x, None, None, training=True, momentum=0.0, eps=EPS)


class UnetResBlock(nn.Module):
    """conv1 and conv2 'same' 3^3 convolutions (nn/unet3d.py::ValidConv3d of
    the input zero-padded by one voxel: channels_last_3d on the card,
    enc0's 4-channel first one the thin-input kernel there and those with
    48 output channels the same-convolution kernel), conv3 the 1^3 one of
    the residual where the widths differ."""

    def __init__(self, cin, cout, dtype=None):
        super().__init__()
        self.conv1 = _Convolution(ValidConv3d(cin, cout, 3, dtype=dtype, padding=1))
        self.conv2 = _Convolution(ValidConv3d(cout, cout, 3, dtype=dtype, padding=1))
        if cin != cout:
            self.conv3 = _Convolution(PointwiseConv3d(cin, cout, 1, dtype=dtype))

    def forward(self, x):
        with tracing.span("predict3d.resblock"):
            y = _norm(self.conv2.conv(F.leaky_relu_(_norm(self.conv1.conv(x)), SLOPE)))
            y += _norm(self.conv3.conv(x)) if hasattr(self, "conv3") else x
            return F.leaky_relu_(y, SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin, cout, dtype=None):
        super().__init__()
        self.layer = UnetResBlock(cin, cout, dtype)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin, cout, dtype=None):
        super().__init__()
        self.transp_conv = _Convolution(UpConv3d(cin, dtype, out_channels=cout))
        self.conv_block = UnetResBlock(2 * cout, cout, dtype)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv.conv(x), skip], 1))


class UnetOutBlock(nn.Module):
    """The head: a float32 1^3 convolution with a bias (PointwiseConv3d
    without a dtype computes in float32 on the bf16 features)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _Convolution(PointwiseConv3d(cin, cout, 1), bias=True)


class SwinUNETR(nn.Module):
    """Swin UNETR (module docstring) of `in_channels` input sequences and
    `out_channels` outputs at `feature_size` F (48 published); `dtype`
    the activations' (None: float32). forward: (N, in, D, H, W) windows,
    D, H and W multiples of 32, to (N, out, D, H, W) float32 logits, the
    (N, D, H, W, out) memory seen channels-first."""

    def __init__(self, in_channels=4, out_channels=3, feature_size=48, dtype=None):
        super().__init__()
        f = feature_size
        self.dtype = dtype
        self.out_channels = out_channels
        self.swinViT = SwinTransformer(in_channels, f)
        self.encoder1 = UnetrBasicBlock(in_channels, f, dtype)
        self.encoder2 = UnetrBasicBlock(f, f, dtype)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f, dtype)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f, dtype)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f, dtype)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f, dtype)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, dtype)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, dtype)
        self.decoder2 = UnetrUpBlock(2 * f, f, dtype)
        self.decoder1 = UnetrUpBlock(f, f, dtype)
        self.out = UnetOutBlock(f, out_channels)

    def init_(self, generator):
        """MONAI's draws: every Linear's weight N(0, 0.02^2) cut at +-2 and
        its bias 0, the relative-position tables so too; LayerNorms 1 and
        0; every convolution he_normal (fan-in the terms of one output;
        the transposed ones' the input channels), the biases 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("relative_position_bias_table") or (
                        p.dim() == 2 and ".norm" not in name):
                    nn.init.trunc_normal_(p, 0.0, 0.02, -2.0, 2.0, generator=generator)
                elif p.dim() == 5:
                    fan = p.shape[0] if "transp_conv" in name else math.prod(p.shape[1:])
                    _variance_scaling_(p, 2.0, fan, generator)
                elif "norm" in name and name.endswith("weight"):
                    nn.init.ones_(p)
                else:
                    nn.init.zeros_(p)
        return self

    def decode(self, x, hidden):
        """The convolutional encoders and decoder of one window: x (1, in,
        D, H, W), hidden its x0'-x4'; (1, D, H, W, out) float32 logits."""
        h0, h1, h2, h3, h4 = hidden
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(h0)
        enc2 = self.encoder3(h1)
        enc3 = self.encoder4(h2)
        dec4 = self.encoder10(h4)
        dec3 = self.decoder5(dec4, h3)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0, enc0)
        return self.out.conv.conv(out).permute(0, 2, 3, 4, 1)

    def forward(self, x):
        dt = self.dtype or torch.float32
        x = x.to(dt)
        hidden = self.swinViT(x, dt)
        logits = [self.decode(x[i:i + 1], [t[i:i + 1] for t in hidden])
                  for i in range(x.shape[0])]
        return torch.cat(logits).permute(0, 4, 1, 2, 3)
