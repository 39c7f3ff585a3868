"""Weights of the JAX package -> the port's state_dicts.

Takes nested dicts of arrays (a component's `params` and its
`batch_stats`, as the JAX package's DAFNet.init returns them) and needs no
JAX. Flax paths map onto the port's module names, which carry the Flax
auto-names:

  down1/ConvBlock_0/Conv_0/kernel            -> down1.ConvBlock_0.Conv_0.weight
  down1/ConvBlock_0/Norm_0/BatchNorm_0/scale -> down1.ConvBlock_0.Norm_0.weight
  .../Norm_0/BatchNorm_0/mean (batch_stats)  -> ....Norm_0.running_mean
  locnet/Dense_0/kernel                      -> locnet.Dense_0.weight

Conv kernels go HWIO -> OIHW, Dense kernels (in, out) -> (out, in).
"""

from collections.abc import Mapping

import numpy as np
import torch

_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path):
    # the JAX Norm wrapper holds its BatchNorm as Norm_k/BatchNorm_0; the
    # port's Norm_k is the BatchNorm itself
    mods = [p for i, p in enumerate(path[:-1])
            if not (p == "BatchNorm_0" and i > 0 and path[i - 1].startswith("Norm_"))]
    return ".".join(mods + [_LEAF[path[-1]]])


def _to_torch(leaf, arr):
    a = np.array(arr, dtype=np.float32)
    if leaf == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def component_state_dict(params, batch_stats=None):
    """state_dict for one component from its JAX params and batch_stats."""
    sd = {}
    for tree in (params, batch_stats or {}):
        for path, arr in _flatten(tree):
            sd[_torch_key(path)] = _to_torch(path[-1], arr)
    return sd


def load_jax_weights(model, params, state):
    """Load the JAX package's DAFNet (params, state) into the port's DAFNet
    (its three inference components), strictly by name and shape."""
    batch_stats = state.get("batch_stats", {})
    for name in ("enc_anatomy", "fuser", "segmentor"):
        getattr(model, name).load_state_dict(
            component_state_dict(params[name], batch_stats.get(name))
        )
    return model
