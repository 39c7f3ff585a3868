"""The reference model of configurations whose model is `unet3d`: the 3D
U-Net of Cicek, Abdulkadir, Lienkamp, Brox and Ronneberger, "3D U-Net:
Learning Dense Volumetric Segmentation from Sparse Annotation" (MICCAI
2016, arXiv:1606.06650, section 2 and Fig. 1), and its overlap-tile
inference over a whole volume, in plain PyTorch, float32, channels-first.

Per level of the analysis path two valid (unpadded) 3x3x3 convolutions,
each followed by BatchNorm and ReLU, whose widths double within the level
(filters * 2**l, then twice that), then a 2x2x2 max pool with stride 2;
the bottom level has no pool. Per level of the synthesis path a 2x2x2
up-convolution with stride 2 that keeps the channels, the analysis
level's output cropped to its centre and concatenated after it, then two
3x3x3 conv + BatchNorm + ReLU down to the level's width. A 1x1x1
convolution to the classes and a softmax end it. Every convolution but
the up-convolutions has a bias.

Departures from the paper, each the program's too:
  - BatchNorm normalises with running statistics (drawn from the seed with
    the weights), as at inference; the paper trains with batch statistics.
  - A whole volume is served by U-Net's overlap-tile strategy (Ronneberger
    et al., arXiv:1505.04597, Fig. 2): mirrored at its borders by the
    net's context and by what more makes each axis a whole number of
    output tiles (numpy.pad's 'reflect'), cut into input tiles on a
    stride of one output tile, the outputs put edge to edge and cropped.
    The paper reports the tile sizes, not how it stitched a volume.

Modules whose values the program holds in its compute dtype have
`compute = True` and round them with `q` (precision.py): a convolution's
operands and output, the bias add, BatchNorm's centred, scaled and
shifted values, the up-convolution's operands and output. The head's
convolution and the softmax stay float32, as in the program. Module names
match the program's (nn/unet3d.py::UNet3DCicek), so one state_dict loads
into both. Imports nothing of the program.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import exact


class Conv(nn.Module):
    """A valid cubic convolution with a bias; `compute` rounds its operands,
    its output and the bias add with `q`."""

    q = staticmethod(exact)

    def __init__(self, cin, cout, k, compute=True):
        super().__init__()
        self.compute = compute
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        q = self.q
        y = q(F.conv3d(q(x), q(self.weight)))
        return q(y + q(self.bias).view(1, -1, 1, 1, 1))


class UpConv(nn.Module):
    """2x2x2 transposed convolution, stride 2, no bias, channels kept."""

    compute = True
    q = staticmethod(exact)

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 2, 2, 2))

    def forward(self, x):
        q = self.q
        return q(F.conv_transpose3d(q(x), q(self.weight), stride=2))


class EvalBatchNorm(nn.Module):
    """(x - running_mean) * (rsqrt(running_var + eps) * weight) + bias, per
    channel, eps 1e-3 (Keras'), each step rounded with `q`."""

    compute = True
    q = staticmethod(exact)

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x):
        q = self.q
        c = (1, -1, 1, 1, 1)
        mul = q(torch.rsqrt(self.running_var + self.eps) * self.weight)
        centred = q(x - q(self.running_mean).view(c))
        return q(q(centred * mul.view(c)) + q(self.bias).view(c))


class Block(nn.Module):
    """Two valid 3x3x3 conv + BatchNorm + ReLU: cin -> mid -> cout."""

    def __init__(self, cin, mid, cout):
        super().__init__()
        self.conv_0, self.bn_0 = Conv(cin, mid, 3), EvalBatchNorm(mid)
        self.conv_1, self.bn_1 = Conv(mid, cout, 3), EvalBatchNorm(cout)

    def forward(self, x):
        x = F.relu(self.bn_0(self.conv_0(x)))
        return F.relu(self.bn_1(self.conv_1(x)))


def crop_to(x, like):
    """The centre of (B, C, D, H, W) x with like's (D, H, W)."""
    out = x
    for axis in (2, 3, 4):
        cut = (x.shape[axis] - like.shape[axis]) // 2
        out = out.narrow(axis, cut, like.shape[axis])
    return out


class MODEL(nn.Module):
    """The 3D U-Net from a configuration's fields: volume_shape (the input
    tile as (D, H, W, channels)), filters3d (the first width), downsample3d
    (the pooling levels) and num_masks (the classes but the background).
    forward: (N, channels, D, H, W) tiles to (N, classes, D', H', W') class
    probabilities."""

    def __init__(self, conf):
        super().__init__()
        self.depth = conf.downsample3d
        self.tile = tuple(conf.volume_shape[:3])
        channels = conf.volume_shape[3]
        f = conf.filters3d
        for level in range(self.depth + 1):
            width = f * 2 ** level
            cin = channels if level == 0 else width
            setattr(self, "analysis_%d" % level, Block(cin, width, 2 * width))
        for i in range(self.depth):
            level = self.depth - 1 - i
            below = f * 2 ** (level + 2)          # channels coming up from below
            skip = f * 2 ** (level + 1)           # channels of the analysis level
            setattr(self, "upconv_%d" % i, UpConv(below))
            setattr(self, "synthesis_%d" % i, Block(below + skip, skip, skip))
        self.head = Conv(2 * f, conf.num_masks + 1, 1, compute=False)

    def forward(self, x):
        skips = []
        for level in range(self.depth):
            x = getattr(self, "analysis_%d" % level)(x)
            skips.append(x)
            x = F.max_pool3d(x, kernel_size=2, stride=2)
        x = getattr(self, "analysis_%d" % self.depth)(x)
        for i in range(self.depth):
            x = getattr(self, "upconv_%d" % i)(x)
            x = torch.cat([x, crop_to(skips[self.depth - 1 - i], x)], dim=1)
            x = getattr(self, "synthesis_%d" % i)(x)
        return torch.softmax(self.head(x), dim=1)


def output_tile(model):
    """The output tile's (D, H, W) of the model's input tile: each analysis
    level takes 4 voxels and halves, the bottom takes 4, each synthesis
    level doubles and takes 4."""
    out = []
    for s in model.tile:
        for _ in range(model.depth):
            s = (s - 4) // 2
        s -= 4
        for _ in range(model.depth):
            s = 2 * s - 4
        out.append(s)
    return tuple(out)


@torch.no_grad()
def predict_volume(model, volume, batch, device):
    """Class probabilities (D, H, W, classes), float32 numpy, of a (D, H,
    W, channels) numpy volume by overlap-tile through `model` on
    `device`, `batch` input tiles a forward."""
    tile_in, tile_out = model.tile, output_tile(model)
    size = volume.shape[:3]
    counts = [-(-s // o) for s, o in zip(size, tile_out)]
    before = [(i - o) // 2 for i, o in zip(tile_in, tile_out)]
    after = [c * o - s + b for c, o, s, b in zip(counts, tile_out, size, before)]
    padded = np.pad(volume, list(zip(before, after)) + [(0, 0)], mode="reflect")
    x = torch.from_numpy(np.ascontiguousarray(padded.transpose(3, 0, 1, 2))).to(device)
    classes = model.head.weight.shape[0]
    out = torch.zeros((classes,) + tuple(c * o for c, o in zip(counts, tile_out)), device=device)
    corners = [(i * tile_out[0], j * tile_out[1], k * tile_out[2])
               for i in range(counts[0]) for j in range(counts[1]) for k in range(counts[2])]
    for b in range(0, len(corners), batch):
        part = corners[b:b + batch]
        tiles = torch.stack([x[:, d:d + tile_in[0], h:h + tile_in[1], w:w + tile_in[2]]
                             for d, h, w in part])
        probs = model(tiles)
        for (d, h, w), p in zip(part, probs):
            out[:, d:d + tile_out[0], h:h + tile_out[1], w:w + tile_out[2]] = p
        del tiles, probs
    return out[:, :size[0], :size[1], :size[2]].permute(1, 2, 3, 0).cpu().numpy()
