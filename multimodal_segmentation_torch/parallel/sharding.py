"""Tensor parallelism over the mesh's 'model' axis.

Port of multimodal_segmentation_tpu/parallel/sharding.py:18-55. JAX's rule
shards a leaf of the train state over 'model' when its shape has at least
two dims and a last dim of at least `min_features` that 'model' divides.
The rule reads the JAX package's (Flax) shapes, taken here through
utils/convert.py::flax_shape: a conv or dense kernel's last Flax dim is
its out channels, torch's dim 0 of the port's Conv2d or Linear weight.
(Read off torch shapes the rule would pick other leaves.) No buffer
qualifies: BatchNorm statistics are 1-D and a spectral `u` is (dim, 1).

A sharded parameter holds this rank's slice of its out channels, and its
`model_axis` attribute names the axis. The Adam moments and the SWA copy
follow it: they are made from it, or cut with it. Each forward gathers the
whole weight (parallel/collectives.py::whole_weight), so every rank of
'model' computes the unsharded function: spectral norm, BatchNorm and the
TPS fuser see whole tensors, and on the CPU a (1, 2) mesh gives the
one-process step bit for bit. Only the storage is split, which is what
the JAX function is for: it "halves per-device optimizer+param memory for
the sharded layers". GSPMD also splits the compute, a speed choice on
which no value depends. The steps (train/steps.py) average the replicated
leaves' gradients over the whole mesh, so they stay identical across
'model', and the sharded slices' over 'data' only.

The checkpoint and the component export hold whole tensors
(`whole_named`, `whole_optimizer_state`; utils/checkpoint.py), so a run
on a mesh and a run in one process read each other's files; `local_part`
cuts a whole tensor back to this rank's slice.
"""

import contextlib

import torch

from multimodal_segmentation_torch.parallel.collectives import gather
from multimodal_segmentation_torch.utils.convert import flax_shape

# JAX's default width from which a leaf is sharded; the executor shards at it
MIN_FEATURES = 256


def _qualifies(shape, n_model, min_features):
    """JAX's _leaf_spec rule on a Flax shape: sharded over 'model' or not."""
    return len(shape) >= 2 and shape[-1] >= min_features and shape[-1] % n_model == 0


def _global_shape(p):
    """The unsharded torch shape of parameter `p`."""
    axis = getattr(p, "model_axis", None)
    if axis is None:
        return tuple(p.shape)
    return (p.shape[0] * axis.size,) + tuple(p.shape[1:])


def tp_leaf_names(tree, n_model, min_features=MIN_FEATURES):
    """The names of the leaves of `tree` that the rule shards over a
    'model' axis of n_model ranks: `tree` is a module (its parameters, by
    their unsharded shapes) or {state_dict key: tensor or shape}."""
    if isinstance(tree, torch.nn.Module):
        shapes = {n: _global_shape(p) for n, p in tree.named_parameters()}
    else:
        shapes = {n: tuple(getattr(t, "shape", t)) for n, t in tree.items()}
    return [n for n, s in shapes.items() if _qualifies(flax_shape(n, s), n_model, min_features)]


def count_sharded_leaves(mesh, tree, min_features=MIN_FEATURES):
    """How many leaves of `tree` (as tp_leaf_names takes it) the rule
    shards over mesh's 'model' axis (parallel/sharding.py:48-55)."""
    n_model = mesh.shape["model"]
    if n_model == 1:
        return 0
    return len(tp_leaf_names(tree, n_model, min_features))


def sharded_parameters(model):
    """{name: parameter} of the parameters this rank holds a slice of."""
    return {n: p for n, p in model.named_parameters()
            if getattr(p, "model_axis", None) is not None}


def _slice(t, axis):
    k = t.shape[0] // axis.size
    return t[axis.index * k:(axis.index + 1) * k]


def _optimizers(ts):
    return [ts.opt_gen, *ts.opt_disc.values()] + ([ts.opt_zreg] if ts.opt_zreg else [])


_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


@torch.no_grad()
def tp_shard_train_state(mesh, ts, min_features=MIN_FEATURES):
    """Shard the wide parameters of train state `ts` over mesh's 'model'
    axis, in place (parallel/sharding.py:29-45): each becomes this rank's
    slice of its out channels, and so do its Adam moments, where an
    optimizer has them already, and its SWA copy. Every other leaf stays
    replicated. The optimizers keep their parameters (the same objects).
    With 'model' of size 1 nothing changes. Returns ts."""
    axis = mesh.axis("model")
    if axis.size == 1:
        return ts
    params = dict(ts.model.named_parameters())
    for name in tp_leaf_names(ts.model, axis.size, min_features):
        p = params[name]
        if getattr(p, "model_axis", None) is not None:
            continue
        if p.dim() not in (2, 4):
            raise ValueError("%s: only Conv2d and Linear weights are sharded, got shape %s"
                             % (name, tuple(p.shape)))
        for opt in _optimizers(ts):
            st = opt.state.get(p)
            for key in _MOMENTS:
                if st is not None and key in st:
                    st[key] = _slice(st[key], axis).clone()
        ts.swa[name] = _slice(ts.swa[name], axis).clone()
        p.data = _slice(p.data, axis).clone()
        p.model_axis = axis
    return ts


def _whole(t, p):
    """`t`, shaped like parameter p's local part, made whole."""
    axis = getattr(p, "model_axis", None)
    return t if axis is None else gather(t.contiguous(), 0, axis)


def local_part(t, p):
    """This rank's part of `t`, shaped like parameter `p` unsharded."""
    axis = getattr(p, "model_axis", None)
    return t if axis is None else _slice(t, axis)


def whole_named(model, named):
    """{parameter name: tensor} (parameters, an SWA average) with each
    sharded leaf gathered whole. A collective under tensor parallelism:
    every rank calls it."""
    params = dict(model.named_parameters())
    return {n: _whole(t, params[n]) if n in params else t for n, t in named.items()}


def _params_of(opt):
    return [p for g in opt.param_groups for p in g["params"]]


def whole_optimizer_state(opt):
    """opt.state_dict() with the moments of sharded parameters whole
    (collective); the optimizer's own state is not touched."""
    sd = opt.state_dict()
    params = _params_of(opt)
    state = {}
    for i, st in sd["state"].items():
        st = dict(st)
        for key in _MOMENTS:
            if key in st:
                st[key] = _whole(st[key], params[i])
        state[i] = st
    return {**sd, "state": state}


def local_optimizer_state(opt, sd):
    """Inverse of whole_optimizer_state: a state_dict of whole moments cut
    to this rank's parts, for opt.load_state_dict."""
    params = _params_of(opt)
    state = {}
    for i, st in sd["state"].items():
        st = dict(st)
        for key in _MOMENTS:
            if key in st:
                st[key] = local_part(st[key], params[i])
        state[i] = st
    return {**sd, "state": state}


@contextlib.contextmanager
def unsharded(model):
    """Within the block every sharded parameter holds its whole weight and
    computes without collectives, so one rank can run the model alone
    (images, the test). Every rank enters it (the gather is a collective);
    the slices come back after it. Read only: no optimizer step inside."""
    sharded = sharded_parameters(model)
    saved = {}
    with torch.no_grad():
        for n, p in sharded.items():
            saved[n] = (p.data, p.model_axis)
            p.data = gather(p.data, 0, p.model_axis)
            p.model_axis = None
    try:
        yield
    finally:
        for n, p in sharded.items():
            p.data, p.model_axis = saved[n]
