"""Seeded weights of a model, made on the device in a few large calls and
handed to the program and to the reference alike.

The model's structure is the reference's (benchmark/reference/models.py),
built on the meta device, so nothing of the program is read. Kernels of
convolutions and dense layers are drawn as Flax draws them: a unit normal
cut at +-2, scaled by sqrt(scale / fan) / 0.8796 (he_normal: 2 / fan_in;
lecun_normal: 1 / fan_in; glorot_normal: 2 / (fan_in + fan_out)); a
zero-initialised dense kernel stays 0. Biases are 0; BatchNorm scales 1,
offsets 0, running means 0 and variances 1; each spectral vector `u` is
uniform in [-1, 1). Then the configuration file's `weights` changes apply:
`gain` multiplies the named tensors and `normal_std` draws the named ones
anew from N(0, std) (names match by suffix).
"""

import math

import torch

from benchmark.reference import layers
from benchmark.reference.models import MODELS

_TRUNC_STD = 0.87962566103423978


def _std(module):
    w = module.weight
    if module.init_kind == "zeros":
        return 0.0
    if isinstance(module, layers.Conv2d):
        kk = w.shape[2] * w.shape[3]
        fan_in, fan_out = w.shape[1] * kk, w.shape[0] * kk
    else:
        fan_in, fan_out = w.shape[1], w.shape[0]
    scale, fan = {"he_normal": (2.0, fan_in),
                  "glorot_normal": (1.0, (fan_in + fan_out) / 2.0)}.get(module.init_kind,
                                                                        (1.0, fan_in))
    return math.sqrt(scale / fan) / _TRUNC_STD


def make(conf, changes, seed, device):
    """{state_dict key: float32 tensor on `device`} of conf.model."""
    with torch.device("meta"):
        model = MODELS[conf.model](conf)
    g = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    state = {k: torch.zeros(v.shape, device=device) for k, v in model.state_dict().items()}
    kernels = [(name + ".weight", _std(m)) for name, m in model.named_modules()
               if isinstance(m, (layers.Conv2d, layers.Linear))]
    gain = changes.get("gain", {})
    normal_std = changes.get("normal_std", {})
    redrawn = [k for k in state if any(k.endswith(s) for s in normal_std)]
    normal = [(k, s) for k, s in kernels if s > 0 and k not in redrawn]
    flat = torch.randn(sum(state[k].numel() for k, _ in normal) + sum(
        state[k].numel() for k in redrawn), generator=g, device=device)
    o = 0
    for k, s in normal:
        n = state[k].numel()
        state[k] = flat[o:o + n].clamp(-2.0, 2.0).view_as(state[k]) * s
        o += n
    for k in redrawn:
        n = state[k].numel()
        std = next(v for s, v in normal_std.items() if k.endswith(s))
        state[k] = flat[o:o + n].view_as(state[k]) * std
        o += n
    us = [k for k in state if k.endswith(".u")]
    flat_u = torch.rand(sum(state[k].numel() for k in us), generator=g, device=device)
    o = 0
    for k in us:
        n = state[k].numel()
        state[k] = flat_u[o:o + n].view_as(state[k]) * 2.0 - 1.0
        o += n
    for k in state:
        if k.endswith("running_var") or (k.endswith(".weight") and state[k].dim() == 1):
            state[k] = torch.ones_like(state[k])
        for suffix, factor in gain.items():
            if k.endswith(suffix):
                state[k] = state[k] * factor
    return state
