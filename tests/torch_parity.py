"""Shared set-up of the PyTorch port's CPU parity tests (tests/test_torch_*.py).

Weights are made once, by the JAX package's DAFNet.init, then changed from
a numpy seed so that inference exercises every part:
  * running statistics of every BatchNorm are random (at init, mean 0 and
    var 1 would leave BN a no-op);
  * the anatomy head's 1x1 kernel is scaled up, so the softmax is sharp and
    rounding leaves a non-empty anatomy (at init every channel is < 0.5
    and the rounded anatomy is all zero);
  * LocNet's last Dense, zero at init (identity warp), gets small weights,
    so the control-point offsets are ~1e-2 to 5e-2.
The same arrays then go to both frameworks, the port's through
multimodal_segmentation_torch/utils/convert.py.
"""

from collections.abc import Mapping

import jax
import numpy as np
import torch

from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_torch.models import build_model as build_torch_model
from multimodal_segmentation_torch.utils.convert import load_jax_weights

ANATOMY_GAIN = 5.0
DENSE1_STD = 0.03


def seeded_batch_stats(tree, rng):
    """Random running statistics: mean ~ N(0, 0.1), var ~ U(0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = seeded_batch_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def jax_dafnet(conf, seed=0):
    """(jax model, params, state) with the seeded changes above; numpy leaves."""
    model = build_jax_model(conf)
    params, state = model.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.array, params)
    state = dict(jax.tree_util.tree_map(np.array, state))
    rng = np.random.RandomState(seed)
    state["batch_stats"] = seeded_batch_stats(state["batch_stats"], rng)
    params["enc_anatomy"]["conv_anatomy"]["kernel"] *= ANATOMY_GAIN
    dense1 = params["fuser"]["locnet"]["Dense_1"]
    dense1["kernel"] = rng.normal(0.0, DENSE1_STD, dense1["kernel"].shape).astype(np.float32)
    dense1["bias"] = rng.normal(0.0, DENSE1_STD, dense1["bias"].shape).astype(np.float32)
    return model, params, state


def torch_dafnet(conf, params, state):
    """The port's DAFNet on the CPU, holding the JAX weights."""
    return load_jax_weights(build_torch_model(conf, device="cpu"), params, state)


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a):
    """NHWC numpy -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2)
