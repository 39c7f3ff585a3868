"""Whole 3-channel volumes and the weights of a volumetric net, made from a
seed on the device and handed to the program and to the reference alike.

A volume is D x H x W voxels: a few smooth ellipsoidal blobs of their own
brightness over a dimmer body that fills most of the field, the same
anatomy seen through one intensity transfer per channel (linear,
saturating, inverted), plus noise, each channel rescaled to [-1, 1], as a
multi-channel microscope or MR series gives it.

The pool of a serving cell holds, for each depth in traffic['depths']
(inclusive), traffic['repeat'] volumes, each of H and W drawn in
traffic['hw'] (inclusive). Its volumes are served in a seeded order, each
once a pass (studies.request_order).

Weights: every convolution's kernel (and the up-convolutions') is drawn
he_normal, a unit normal cut at +-2 scaled by sqrt(2 / fan_in) / 0.8796,
where fan_in counts the terms that sum into one output (in channels x
kernel volume; for a 2x2x2 stride-2 up-convolution, whose output voxels
each take one tap, the in channels); biases are N(0, 0.05^2); each
BatchNorm's scale is U(0.8, 1.2) and its offset N(0, 0.1^2). The running
statistics are those of the BatchNorm's input over one input tile, the
tile at the middle of the overlap-tile grid of a volume of the traffic's
smallest size, drawn from the seed and mirrored at its borders as the
program pads it; the net runs in float32, each BatchNorm taking its
statistics as the tile reaches it; they are then
moved by a seeded draw: the mean by N(0, 0.1^2) of the channel's standard
deviation, the variance, floored at a hundredth of the layer's median,
by a factor exp(U(-0.3, 0.3)). So every layer's
output stays of order one, as a trained net's does, and the class
probabilities do not saturate, which random statistics alone do not give:
a layer's per-channel mean then grows through the depth until one class
takes nearly every voxel.
"""

import math

import numpy as np
import torch

_TRUNC_STD = 0.87962566103423978


def _words(seed, n):
    return [int(w) for w in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def sizes(traffic, seed):
    """[(D, H, W)] of the pool: each depth `repeat` times, H and W seeded."""
    lo, hi = traffic["depths"]
    depths = [d for d in range(lo, hi + 1) for _ in range(traffic["repeat"])]
    rng = np.random.RandomState(_words(seed, 1)[0])
    hw = rng.randint(traffic["hw"][0], traffic["hw"][1] + 1, size=(len(depths), 2))
    return [(d, int(h), int(w)) for d, (h, w) in zip(depths, hw)]


def render(size, channels, blobs, generator, device):
    """One (D, H, W, channels) float32 volume on `device`."""
    D, H, W = size
    g = generator

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    axes = [torch.linspace(-1.0, 1.0, n, device=device) for n in size]
    z, y, x = axes[0][:, None, None], axes[1][None, :, None], axes[2][None, None, :]
    body = torch.sigmoid(8.0 * (1.0 - (y / 0.9) ** 2 - (x / 0.9) ** 2))
    anatomy = 0.3 * body
    centre, radius = u(blobs, 3, lo=-0.6, hi=0.6), u(blobs, 3, lo=0.15, hi=0.4)
    bright = u(blobs, lo=0.3)
    for b in range(blobs):
        d = (((z - centre[b, 0]) / radius[b, 0]) ** 2 + ((y - centre[b, 1]) / radius[b, 1]) ** 2
             + ((x - centre[b, 2]) / radius[b, 2]) ** 2)
        anatomy = anatomy + bright[b] * torch.sigmoid(6.0 * (1.0 - d))
    transfers = (lambda a: a, lambda a: torch.tanh(3.0 * a), lambda a: torch.exp(-2.0 * a))
    out = []
    for c in range(channels):
        t = transfers[c % 3](anatomy) + 0.05 * torch.randn(size, generator=g, device=device)
        lo, hi = t.min(), t.max()
        out.append(2.0 * (t - lo) / (hi - lo) - 1.0)
    return torch.stack(out, dim=-1)


def request_pool(traffic, seed, device):
    """The pool: one (1, D, H, W, channels) float32 numpy array a volume, in
    the order of sizes()."""
    g = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    return [render(s, traffic["channels"], traffic["blobs"], g, device).cpu().numpy()[None]
            for s in sizes(traffic, seed)]


def make_weights(model_cls, conf, traffic, seed, device):
    """{state_dict key: float32 tensor on `device`} of a `model_cls(conf)`
    (module docstring); conf.volume_shape is the input tile's (D, H, W,
    channels)."""
    tile_in, channels = tuple(conf.volume_shape[:3]), conf.volume_shape[3]
    with torch.device("meta"):
        meta = model_cls(conf)
        shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
        tile_out = tuple(meta(torch.zeros((1, channels) + tile_in)).shape[2:])
    g = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    state = {}
    for key, shape in shapes.items():
        n = math.prod(shape)
        if key.endswith("weight") and len(shape) == 5:
            fan_in = shape[0] if "upconv" in key else math.prod(shape[1:])
            t = torch.randn(n, generator=g, device=device).clamp(-2.0, 2.0) * (
                math.sqrt(2.0 / fan_in) / _TRUNC_STD)
        elif key.endswith(("running_mean", "running_var")):
            t = torch.zeros(n, device=device)
        elif ".bn_" in key and key.endswith("weight"):
            t = torch.rand(n, generator=g, device=device) * 0.4 + 0.8
        elif ".bn_" in key:
            t = torch.randn(n, generator=g, device=device) * 0.1
        else:
            t = torch.randn(n, generator=g, device=device) * 0.05
        state[key] = t.view(shape)
    model = model_cls(conf).to(device)
    model.load_state_dict(state)

    def take_statistics(norm, args):
        x = args[0].double()
        var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), unbiased=False)
        # a channel nearly constant over the tile keeps a hundredth of the
        # layer's median variance, not a BatchNorm that magnifies by 1/sqrt(eps)
        var = torch.maximum(var, 0.01 * var.median())
        c = mean.numel()
        norm.running_mean.copy_(
            (mean + torch.randn(c, generator=g, device=device) * 0.1 * var.sqrt()).float())
        norm.running_var.copy_(
            (var * torch.exp(torch.rand(c, generator=g, device=device) * 0.6 - 0.3)).float())

    hooks = [m.register_forward_pre_hook(take_statistics) for m in model.modules()
             if hasattr(m, "running_var")]
    size = (traffic["depths"][0], traffic["hw"][0], traffic["hw"][0])
    volume = render(size, channels, traffic["blobs"], g, device)
    for axis, (n, i, o) in enumerate(zip(size, tile_in, tile_out)):
        count, margin = -(-n // o), (i - o) // 2
        mirrored = np.pad(np.arange(n), (margin, count * o - n + margin), mode="reflect")
        start = count // 2 * o
        volume = volume.index_select(axis, torch.from_numpy(mirrored[start:start + i]).to(device))
    with torch.no_grad():
        model(volume.permute(3, 0, 1, 2)[None])
    for h in hooks:
        h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
