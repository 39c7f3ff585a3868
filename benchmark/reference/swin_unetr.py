"""The reference model of configurations whose model is `swin_unetr`: Swin
UNETR of Hatamizadeh, Nath, Tang, Yang, Roth and Xu, "Swin UNETR: Swin
Transformers for Semantic Segmentation of Brain Tumors in MRI Images"
(arXiv:2201.01266), as MONAI's monai/networks/nets/swin_unetr.py builds
it (normalize=True, norm_name="instance"), and MONAI's
sliding_window_inference over a whole study (mode "constant"), in plain
PyTorch, float32, channels-first.

Swin encoder: a 2x2x2 stride-2 Conv3d patch embedding with a bias, four
stages of two Swin blocks at width C = F * 2**i, heads 3, 6, 12, 24,
window 7^3, each block x + attention(LN1(x)) then x + MLP(LN2(x)) (MLP
C -> 4C -> C, exact GELU); the attention pads the normed tokens with
zeros to a multiple of the window, rolls them by -3 on each axis in odd
blocks, attends in each window with q scaled by head_dim^-0.5, q k^T
plus the relative-position bias (a (13^3, heads) table) plus, in rolled
blocks, -100 between shift regions, softmax, times v, the projection,
then undoes the windows, the roll and the padding; an axis no longer
than the window takes its size as the window and no roll, and its bias
is read at the first n x n entries of the 7^3 index (MONAI's rules).
Each stage ends in patch merging. The hidden states are layer-normed
over C without affine parameters. Convolutional path: MONAI's
UnetResBlock (3^3 conv, InstanceNorm, LeakyReLU 0.01, 3^3 conv,
InstanceNorm, plus the input or its 1^3 conv and InstanceNorm, LeakyReLU;
no conv bias), UnetrBasicBlock encoders on the input and on x0'-x2' and
x4', UnetrUpBlock decoders (2x2x2 stride-2 transposed conv without a
bias, the skip concatenated after it, a UnetResBlock), and a 1^3 conv
head with a bias. Sliding window: windows of the configuration's roi on
a stride of int(roi * (1 - overlap)) a axis, the last flush with the
study's end (MONAI's _get_scan_interval and dense_patch_slices; an axis
shorter than the roi is zero-padded around the study first), the
windows' logits averaged over the windows that cover each voxel, then a
sigmoid.

Departures from MONAI, each the program's too:
  - patch merging is MONAI's PatchMergingV2 (the 8 voxels of a 2x2x2
    block in itertools.product((0, 1), repeat=3) order); MONAI's
    SwinUNETR defaults to its legacy `merging`, which takes two of the
    eight voxels twice;
  - InstanceNorm without affine parameters and running statistics, as
    norm_name="instance" builds it; no dropout;
  - weights drawn from the run's seed (benchmark/traffic/swin_weights.py),
    not trained ones.

Modules whose values the program holds in its compute dtype have
`compute = True` and round them with `q` (precision.py): a linear map's
or convolution's operands and output, LayerNorm's and InstanceNorm's
outputs, the attention's q, k, v (the linear map's output), its
probabilities and their product with v, GELU's and LeakyReLU's outputs
and the residual sums. The attention's scores, bias, mask and softmax,
the head and the average stay float32, as in the program. Module names
match the program's (nn/swin_unetr.py::SwinUNETR), so one state_dict
loads into both. Imports nothing of the program.
"""

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import exact

WINDOW = 7
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)


class Rounded(nn.Module):
    """A module of the compute dtype: `q` rounds what it holds."""

    compute = True
    q = staticmethod(exact)


def _window(size):
    ws = [s if s <= WINDOW else WINDOW for s in size]
    shift = [0 if s <= WINDOW else WINDOW // 2 for s in size]
    return ws, shift


def _bias_index():
    coords = torch.stack(torch.meshgrid(*[torch.arange(WINDOW)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (WINDOW - 1)
    span = 2 * WINDOW - 1
    return (rel[..., 0] * span + rel[..., 1]) * span + rel[..., 2]


def _windows(x, ws):
    """(B, D, H, W, C) -> (B * windows, n, C), windows in (b, d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def _unwindows(x, ws, b, d, h, w):
    x = x.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def _regions(dims, ws, shift, device):
    """(windows, n, n): -100 between tokens of different shift regions."""
    label = torch.zeros(1, *dims, 1, device=device)
    parts = [(slice(0, -w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, shift)]
    for i, (a, b, c) in enumerate(itertools.product(*parts)):
        label[:, a, b, c, :] = i
    lab = _windows(label, ws)[..., 0]
    return (lab[:, None, :] != lab[:, :, None]).float() * -100.0


class Linear(Rounded):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        q = self.q
        return q(F.linear(q(x), q(self.weight), None if self.bias is None else q(self.bias)))


class LayerNorm(Rounded):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        q = self.q
        return q(F.layer_norm(x, x.shape[-1:], q(self.weight), q(self.bias), 1e-5))


class WindowAttention(Rounded):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * WINDOW - 1) ** 3, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask):
        q = self.q
        bw, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        query, key, value = qkv[0] * (c // h) ** -0.5, qkv[1], qkv[2]
        scores = query @ key.transpose(-2, -1)
        index = _bias_index().to(x.device)[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[index].reshape(n, n, h).permute(2, 0, 1)
        scores = scores + bias[None]
        if mask is not None:
            scores = (scores.reshape(-1, mask.shape[0], h, n, n) + mask[None, :, None]
                      ).reshape(bw, h, n, n)
        out = q(q(torch.softmax(scores, -1)) @ value)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class MLPBlock(Rounded):
    def __init__(self, dim):
        super().__init__()
        self.linear1 = Linear(dim, 4 * dim)
        self.linear2 = Linear(4 * dim, dim)

    def forward(self, x):
        return self.linear2(self.q(F.gelu(self.linear1(x))))


class SwinTransformerBlock(Rounded):
    def __init__(self, dim, heads, shifted):
        super().__init__()
        self.shifted = shifted
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim)

    def forward(self, x):
        q = self.q
        b, d, h, w, c = x.shape
        ws, shift = _window((d, h, w))
        dims = [-(-s // n) * n for s, n in zip((d, h, w), ws)]
        y = torch.zeros(b, *dims, c, device=x.device)
        y[:, :d, :h, :w] = self.norm1(x)
        roll = self.shifted and any(shift)
        if roll:
            y = torch.roll(y, [-s for s in shift], (1, 2, 3))
        mask = _regions(dims, ws, shift, x.device) if roll else None
        y = _unwindows(self.attn(_windows(y, ws), mask), ws, b, *dims)
        if roll:
            y = torch.roll(y, shift, (1, 2, 3))
        x = q(x + y[:, :d, :h, :w])
        return q(x + self.mlp(self.norm2(x)))


class PatchMergingV2(Rounded):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        parts = [x[:, i::2, j::2, k::2] for i, j, k in itertools.product((0, 1), repeat=3)]
        return self.reduction(self.norm(torch.cat(parts, -1)))


class BasicLayer(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.blocks = nn.ModuleList([SwinTransformerBlock(dim, heads, False),
                                     SwinTransformerBlock(dim, heads, True)])
        self.downsample = PatchMergingV2(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class Conv(Rounded):
    """A Conv3d (or ConvTranspose3d) under `conv`, 'same' zero padding."""

    def __init__(self, cin, cout, k, transposed=False, bias=False, compute=True):
        super().__init__()
        self.compute = compute
        self.transposed = transposed
        make = nn.ConvTranspose3d if transposed else nn.Conv3d
        self.conv = make(cin, cout, k, stride=2 if transposed else 1, bias=bias)

    def forward(self, x):
        q, conv = self.q, self.conv
        bias = None if conv.bias is None else q(conv.bias)
        if self.transposed:
            return q(F.conv_transpose3d(q(x), q(conv.weight), bias, stride=2))
        return q(F.conv3d(q(x), q(conv.weight), bias, padding=conv.kernel_size[0] // 2))


class PatchEmbed(Rounded):
    def __init__(self, cin, dim):
        super().__init__()
        self.proj = nn.Conv3d(cin, dim, 2, stride=2)

    def forward(self, x):
        q = self.q
        y = q(F.conv3d(q(x), q(self.proj.weight), q(self.proj.bias), stride=2))
        return y.permute(0, 2, 3, 4, 1)


class SwinTransformer(Rounded):
    def __init__(self, cin, dim):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        for i, heads in enumerate(HEADS):
            setattr(self, "layers%d" % (i + 1), nn.ModuleList([BasicLayer(dim * 2 ** i, heads)]))

    def forward(self, x):
        x = self.patch_embed(x)
        hidden = [x]
        for i in range(len(DEPTHS)):
            x = getattr(self, "layers%d" % (i + 1))[0](x)
            hidden.append(x)
        return [self.q(F.layer_norm(t, t.shape[-1:], eps=1e-5)).permute(0, 4, 1, 2, 3)
                for t in hidden]


class UnetResBlock(Rounded):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3)
        self.conv2 = Conv(cout, cout, 3)
        self.conv3 = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        q = self.q

        def norm(t):
            return q(F.instance_norm(t, eps=1e-5))

        y = q(F.leaky_relu(norm(self.conv1(x)), 0.01))
        y = norm(self.conv2(y))
        y = q(y + (x if self.conv3 is None else norm(self.conv3(x))))
        return q(F.leaky_relu(y, 0.01))


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = Conv(cin, cout, 2, transposed=True)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], 1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=True, compute=False)

    def forward(self, x):
        return self.conv(x)


class MODEL(nn.Module):
    """Swin UNETR from a configuration's fields: volume_shape (the roi as
    (D, H, W, channels)), filters3d (the feature size) and num_masks (the
    sigmoid outputs). forward: (N, channels, D, H, W) windows to (N,
    outputs, D, H, W) float32 logits."""

    def __init__(self, conf):
        super().__init__()
        self.roi = tuple(conf.volume_shape[:3])
        cin, f = conf.volume_shape[3], conf.filters3d
        self.swinViT = SwinTransformer(cin, f)
        self.encoder1 = UnetrBasicBlock(cin, f)
        self.encoder2 = UnetrBasicBlock(f, f)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f)
        self.decoder1 = UnetrUpBlock(f, f)
        self.out = UnetOutBlock(f, conf.num_masks)

    def forward(self, x):
        h0, h1, h2, h3, h4 = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(h0)
        enc2 = self.encoder3(h1)
        enc3 = self.encoder4(h2)
        dec4 = self.encoder10(h4)
        dec3 = self.decoder5(dec4, h3)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))


def window_starts(size, roi, overlap):
    """Each axis's window starts, MONAI's rule: a stride of int(roi * (1 -
    overlap)) (at least 1; the roi where it equals the axis), windows
    until one reaches the end, the last flush with it."""
    out = []
    for s, r in zip(size, roi):
        step = r if r == s else max(int(r * (1 - overlap)), 1)
        n = next(i for i in range(math.ceil(s / step)) if i * step + r >= s) + 1
        out.append([i * step - max(i * step + r - s, 0) for i in range(n)])
    return out


@torch.no_grad()
def predict_volume(model, volume, batch, device, overlap):
    """Sigmoid probabilities (D, H, W, outputs), float32 numpy, of a (D, H,
    W, channels) numpy study by MONAI's sliding window through `model` on
    `device`, `batch` windows a forward."""
    roi = model.roi
    size = volume.shape[:3]
    grown = [max(s, r) for s, r in zip(size, roi)]
    before = [(g - s) // 2 for g, s in zip(grown, size)]
    x = np.pad(volume, [(b, g - s - b) for b, g, s in zip(before, grown, size)] + [(0, 0)])
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(3, 0, 1, 2))).to(device)
    outputs = model.out.conv.conv.weight.shape[0]
    total = torch.zeros((outputs, *grown), device=device)
    count = torch.zeros(grown, device=device)
    corners = list(itertools.product(*window_starts(grown, roi, overlap)))
    for i in range(0, len(corners), batch):
        part = corners[i:i + batch]
        logits = model(torch.stack([x[:, d:d + roi[0], h:h + roi[1], w:w + roi[2]]
                                    for d, h, w in part]))
        for (d, h, w), z in zip(part, logits):
            total[:, d:d + roi[0], h:h + roi[1], w:w + roi[2]] += z
            count[d:d + roi[0], h:h + roi[1], w:w + roi[2]] += 1
        del logits
    probs = torch.sigmoid(total / count)
    probs = probs[:, before[0]:before[0] + size[0], before[1]:before[1] + size[1],
                  before[2]:before[2] + size[2]]
    return probs.permute(1, 2, 3, 0).cpu().numpy()
