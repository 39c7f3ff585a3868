"""Weights of the JAX package <-> the port's state_dicts.

Takes nested dicts of arrays (a component's `params`, its `batch_stats`
and its `spectral` collection, as the JAX package's DAFNet.init and
MMSDNet.init return them) and needs no JAX. Flax paths map onto the port's module names,
which carry the Flax auto-names:

  down1/ConvBlock_0/Conv_0/kernel            -> down1.ConvBlock_0.Conv_0.weight
  down1/ConvBlock_0/Norm_0/BatchNorm_0/scale -> down1.ConvBlock_0.Norm_0.weight
  (Norm_0/InstanceNorm_0/scale, normalise='instance', likewise)
  .../Norm_0/BatchNorm_0/mean (batch_stats)  -> ....Norm_0.running_mean
  decoder/FiLMDecoder_0/FiLMLayer_0/Dense_1/kernel
                                             -> FiLMDecoder_0.FiLMLayer_0.Dense_1.weight
  decoder/SPADEDecoder_0/SPADEBlock_5/SPADEUnit_2/Conv_1/kernel
                                             -> SPADEDecoder_0.SPADEBlock_5.SPADEUnit_2.Conv_1.weight
  d_mask/SpectralConv_0/kernel               -> SpectralConv_0.weight
  d_mask/SpectralConv_0/u (spectral)         -> SpectralConv_0.u

The volumetric UNet3D (nn/unet3d.py) maps the same way:

  ConvBlock3D_0/Conv_0/kernel                -> ConvBlock3D_0.Conv_0.weight
  ConvBlock3D_0/InstanceNorm3D_0/scale       -> ConvBlock3D_0.InstanceNorm3D_0.weight

Conv kernels go HWIO -> OIHW (3-D: DHWIO -> OIDHW), Dense kernels (in,
out) -> (out, in); the spectral vectors `u` keep the JAX package's HWIO
order (ops/spectral.py).
`component_trees` maps a state_dict back. For the component .npz files
(the JAX package's utils/checkpoint.py:50-108), `params_by_component`
groups model-level parameter names, such as a train state's SWA values,
into per-component params trees, and `flax_paths` / `from_flax_paths`
turn a tree into the '/'-joined Flax path strings those files key by and
back. The volumetric executor's models/cardiac3d.npz (the JAX package's
models/volumetric.py:185-191) keys by jax.tree_util's key path of the
whole variables tree instead, "['params']/['Conv_0']/['kernel']":
`unet3d_npz` / `unet3d_state_dict_from_npz` write and read those keys.
"""

from collections.abc import Mapping

import numpy as np
import torch

# DAFNet's components; MMSDNet's are its model's children
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


_NORM_CHILDREN = ("BatchNorm_0", "InstanceNorm_0")


def _torch_key(path):
    # the JAX Norm wrapper holds its BatchNorm (or InstanceNorm) as
    # Norm_k/BatchNorm_0; the port's Norm_k is the normalisation itself
    mods = [p for i, p in enumerate(path[:-1])
            if not (p in _NORM_CHILDREN and i > 0 and path[i - 1].startswith("Norm_"))]
    return ".".join(mods + [_LEAF[path[-1]]])


# conv kernel axes: Flax (spatial..., in, out) -> torch (out, in, spatial...)
_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
_NORM_PREFIXES = ("Norm_", "BatchNorm_", "InstanceNorm3D_")


def _to_torch(leaf, arr):
    a = np.array(arr, dtype=np.float32)
    if leaf == "kernel":
        a = a.transpose(_TO_TORCH[a.ndim]) if a.ndim in _TO_TORCH else a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def flax_shape(key, shape):
    """The shape the JAX package gives the leaf that the port keeps under
    state_dict key `key` with torch shape `shape`: conv kernels HWIO
    (DHWIO), dense kernels (in, out), everything else as it is."""
    shape = tuple(shape)
    if key.rsplit(".", 1)[-1] == "weight":
        if len(shape) in _TO_FLAX:
            return tuple(shape[i] for i in _TO_FLAX[len(shape)])
        if len(shape) == 2:
            return shape[::-1]
    return shape


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
    has them), in the JAX package's layout. A parameter name does not say
    which normalisation a Norm_k is, so its scale and bias go under
    Norm_k/BatchNorm_0, as every preset has them (normalise='batch')."""
    out = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        is_norm = bool(mods) and mods[-1].startswith(_NORM_PREFIXES)
        if leaf == "weight":
            col, jleaf = "params", ("scale" if is_norm else "kernel")
            if a.ndim in _TO_FLAX:
                a = a.transpose(_TO_FLAX[a.ndim])
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


def params_by_component(named):
    """{'<component>.<torch key>': tensor}, as model.named_parameters() or
    a TrainState's swa holds them -> {component: JAX params tree}."""
    groups = {}
    for key, t in named.items():
        comp, rest = key.split(".", 1)
        groups.setdefault(comp, {})[rest] = t
    return {c: component_trees(sd)["params"] for c, sd in groups.items()}


def flax_paths(tree):
    """Nested dict -> {'a/b/leaf': array}, the keys of the JAX package's
    component .npz files (utils/checkpoint.py:57-61)."""
    return {"/".join(path): arr for path, arr in _flatten(tree)}


def from_flax_paths(flat):
    """Inverse of flax_paths."""
    out = {}
    for key, arr in flat.items():
        *mods, leaf = key.split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return out


def unet3d_npz(state_dict):
    """{key: array} of models/cardiac3d.npz for a UNet3D state_dict: the
    JAX package's '/'-joined key paths of its variables {'params': ...}."""
    tree = {"params": component_trees(state_dict)["params"]}
    return {"/".join("['%s']" % k for k in path): arr for path, arr in _flatten(tree)}


def unet3d_state_dict_from_npz(flat):
    """Inverse of unet3d_npz: a UNet3D state_dict from models/cardiac3d.npz's
    {key: array} (an np.load of the file)."""
    tree = from_flax_paths({"/".join(k[2:-2] for k in key.split("/")): flat[key]
                            for key in flat})
    return component_state_dict(tree["params"])


def load_jax_weights(model, params, state):
    """Load the JAX package's DAFNet or MMSDNet (params, state) into the
    port's model of that kind, every component present in `params`,
    strictly by name and shape."""
    cols = {c: state.get(c, {}) for c in ("batch_stats", "spectral")}
    for name, module in model.named_children():
        if name in params:
            module.load_state_dict(component_state_dict(
                params[name], cols["batch_stats"].get(name), cols["spectral"].get(name)))
    return model
