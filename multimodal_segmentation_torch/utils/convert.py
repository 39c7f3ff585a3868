"""Weights of the JAX package <-> the port's state_dicts.

Takes nested dicts of arrays (a component's `params`, its `batch_stats`
and its `spectral` collection, as the JAX package's DAFNet.init returns
them) and needs no JAX. Flax paths map onto the port's module names,
which carry the Flax auto-names:

  down1/ConvBlock_0/Conv_0/kernel            -> down1.ConvBlock_0.Conv_0.weight
  down1/ConvBlock_0/Norm_0/BatchNorm_0/scale -> down1.ConvBlock_0.Norm_0.weight
  .../Norm_0/BatchNorm_0/mean (batch_stats)  -> ....Norm_0.running_mean
  decoder/FiLMDecoder_0/FiLMLayer_0/Dense_1/kernel
                                             -> FiLMDecoder_0.FiLMLayer_0.Dense_1.weight
  d_mask/SpectralConv_0/kernel               -> SpectralConv_0.weight
  d_mask/SpectralConv_0/u (spectral)         -> SpectralConv_0.u

Conv kernels go HWIO -> OIHW, Dense kernels (in, out) -> (out, in); the
spectral vectors `u` keep the JAX package's HWIO order (ops/spectral.py).
`component_trees` maps a state_dict back.
"""

from collections.abc import Mapping

import numpy as np
import torch

COMPONENTS = ("enc_anatomy", "fuser", "enc_modality", "segmentor", "decoder",
              "balancer", "d_mask", "d_image1", "d_image2")

_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "u": "u",
}
# torch leaf -> (collection, JAX leaf); weights resolve by module kind
_COLLECTION = {
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
    "u": ("spectral", "u"),
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


def component_state_dict(params, batch_stats=None, spectral=None):
    """state_dict for one component from its JAX params, batch_stats and
    spectral trees."""
    sd = {}
    for tree in (params, batch_stats or {}, spectral or {}):
        for path, arr in _flatten(tree):
            sd[_torch_key(path)] = _to_torch(path[-1], arr)
    return sd


def component_trees(state_dict):
    """Inverse of component_state_dict: {collection: nested dict of numpy
    arrays} ('params', and 'batch_stats' / 'spectral' where the component
    has them), in the JAX package's layout."""
    out = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        is_norm = bool(mods) and (mods[-1].startswith("Norm_") or mods[-1].startswith("BatchNorm_"))
        if leaf == "weight":
            col, jleaf = "params", ("scale" if is_norm else "kernel")
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
        else:
            col, jleaf = _COLLECTION[leaf]
        if mods and mods[-1].startswith("Norm_"):
            mods = mods + ["BatchNorm_0"]
        node = out.setdefault(col, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[jleaf] = np.ascontiguousarray(a)
    return out


def load_jax_weights(model, params, state):
    """Load the JAX package's DAFNet (params, state) into the port's
    DAFNet, every component present in `params`, strictly by name and
    shape."""
    cols = {c: state.get(c, {}) for c in ("batch_stats", "spectral")}
    for name in COMPONENTS:
        if name in params:
            getattr(model, name).load_state_dict(component_state_dict(
                params[name], cols["batch_stats"].get(name), cols["spectral"].get(name)))
    return model
