"""The five losses that no training path calls, against the JAX package's
(losses.py:162-245): similarity_weighted_dice, similarity_weighted_mae,
mse, kl_from_stats within 1e-6 relative, and the numpy
distance_correlation within 1e-12. Inputs from a numpy seed, f32 (the
dtype the losses see in training) and, for mse, bf16 too (it casts to f32
as mae does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import losses as jlosses
from multimodal_segmentation_torch import losses as tlosses

torch.set_num_threads(1)


def _inputs(seed=0, B=3, H=8, W=6, C=5):
    r = np.random.RandomState(seed)
    return {"weights_b": r.rand(B).astype(np.float32),
            "weights_bc": r.rand(B, C).astype(np.float32),
            "y_true": (r.rand(B, H, W, C) > 0.6).astype(np.float32),
            "y_pred": r.dirichlet(np.ones(C), size=(B, H, W)).astype(np.float32),
            "z_mean": r.randn(B, 7).astype(np.float32),
            "z_log_var": (0.5 * r.randn(B, 7)).astype(np.float32)}


def _cases(d):
    t, j = torch.from_numpy, jnp.asarray
    return {
        "similarity_weighted_dice": (
            lambda: tlosses.similarity_weighted_dice(t(d["weights_b"]), t(d["y_true"]),
                                                     t(d["y_pred"]), 4),
            lambda: jlosses.similarity_weighted_dice(j(d["weights_b"]), j(d["y_true"]),
                                                     j(d["y_pred"]), 4)),
        "similarity_weighted_mae": (
            lambda: tlosses.similarity_weighted_mae(t(d["weights_bc"]), t(d["y_true"]),
                                                    t(d["y_pred"])),
            lambda: jlosses.similarity_weighted_mae(j(d["weights_bc"]), j(d["y_true"]),
                                                    j(d["y_pred"]))),
        "mse": (lambda: tlosses.mse(t(d["y_true"]), t(d["y_pred"])),
                lambda: jlosses.mse(j(d["y_true"]), j(d["y_pred"]))),
        "mse_bf16": (
            lambda: tlosses.mse(t(d["y_true"]).bfloat16(), t(d["y_pred"]).bfloat16()),
            lambda: jlosses.mse(j(d["y_true"]).astype(jnp.bfloat16),
                                j(d["y_pred"]).astype(jnp.bfloat16))),
        "kl_from_stats": (lambda: tlosses.kl_from_stats(t(d["z_mean"]), t(d["z_log_var"])),
                          lambda: jlosses.kl_from_stats(j(d["z_mean"]), j(d["z_log_var"]))),
    }


@pytest.mark.parametrize("name", ["similarity_weighted_dice", "similarity_weighted_mae", "mse",
                                  "mse_bf16", "kl_from_stats"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_matches_jax(name, seed):
    port, ref = _cases(_inputs(seed))[name]
    got, want = port(), np.asarray(ref())
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [((9, 3), (9, 5)), ((12, 1), (12, 4))])
def test_distance_correlation_matches_jax(shape):
    r = np.random.RandomState(sum(shape[1]))
    a, b = r.randn(*shape[0]), r.randn(*shape[1])
    b[:, 0] += 2.0 * a[:, 0]
    got = tlosses.distance_correlation(a, b)
    want = jlosses.distance_correlation(a, b)
    assert abs(got - want) <= 1e-12 and 0.0 < got <= 1.0
    with pytest.raises(ValueError):
        tlosses.distance_correlation(a, b[:-1])
