"""CPU parity of the training slice's ops with the JAX package's: grouped
train-mode BatchNorm, the rotation augmentation (held also against the
Pallas nearest-warp kernel in interpret mode), the plain version of the
warp backward (held against the Pallas backward kernel in interpret mode
and JAX autodiff), the spectral penalty, the training losses and the
model helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_segmentation_tpu import losses as jlosses
from multimodal_segmentation_tpu.data.batches import BatchStream as JBatchStream
from multimodal_segmentation_tpu.models import base as jbase
from multimodal_segmentation_tpu.nn.blocks import BatchNorm as JBatchNorm
from multimodal_segmentation_tpu.ops import augment as jaugment
from multimodal_segmentation_tpu.ops import spectral as jspectral
from multimodal_segmentation_tpu.ops import tps as jtps
from multimodal_segmentation_tpu.ops.pallas_kernels import (
    nearest_warp_pallas,
    tps_bilinear_warp_bwd_pallas,
)
from multimodal_segmentation_torch import losses as tlosses
from multimodal_segmentation_torch.data.batches import BatchStream
from multimodal_segmentation_torch.models import base as tbase
from multimodal_segmentation_torch.nn.blocks import BatchNorm
from multimodal_segmentation_torch.ops import augment, cuda_kernels, spectral, tps
from torch_parity import nchw, nhwc
from torch_warp_reference import offsets_gradient_reference

torch.set_num_threads(1)


# ------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_batchnorm_train_matches_jax(groups):
    """Outputs at 1e-5 (f32 sums over 2*G*8*8 values in two orders) and
    the running statistics after one update at 1e-6."""
    r = np.random.RandomState(groups)
    C = 6
    x = (r.randn(2 * groups, 8, 8, C) * 2 + 0.5).astype(np.float32)
    scale = r.uniform(0.5, 1.5, C).astype(np.float32)
    bias = r.normal(0, 0.2, C).astype(np.float32)
    mean0 = r.normal(0, 0.1, C).astype(np.float32)
    var0 = r.uniform(0.5, 1.5, C).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jbn = JBatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3, groups=groups)
    ref, upd = jbn.apply(variables, x, mutable=["batch_stats"])

    bn = BatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    got = bn.train()(nchw(x), groups)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-6)


def test_grouped_batchnorm_groups_are_interleaved():
    """Row b*G + g belongs to group g: a grouped call equals separate
    calls on each group's rows."""
    x = torch.from_numpy(np.random.RandomState(0).randn(6, 3, 4, 4).astype(np.float32))
    bn = BatchNorm(3).train()
    got = bn(x, groups=3)
    for g in range(3):
        alone = BatchNorm(3).train()(x[g::3])
        torch.testing.assert_close(got[g::3], alone, atol=1e-5, rtol=0)


def test_grouped_batchnorm_rejects_uneven_groups():
    with pytest.raises(ValueError, match="divisible"):
        BatchNorm(3).train()(torch.zeros(5, 3, 2, 2), groups=2)


# ------------------------------------------------------------- rotation

ANGLES_DEG = np.array([0.0, 20.0, -20.0, 7.3, -13.9, 19.99], np.float32)


def _angles():
    return (ANGLES_DEG * np.float32(np.pi / 180.0)).astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (192, 192), (17, 24)])
def test_rotation_locations_match_jax(hw):
    """Same f32 operations in the same order; sin/cos of the two libraries
    may differ by an ulp, so the locations agree to 1e-5 px, exactly at 0."""
    th = _angles()
    ref = np.asarray(jaugment.rotation_locations(jnp.asarray(th), *hw))
    got = augment.rotation_locations(torch.from_numpy(th), *hw).numpy()
    assert got.shape == ref.shape == (len(th), hw[0] * hw[1], 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("C", [10, 8, 2])
def test_rotate_batch_matches_jax_exactly(C):
    """Images and {0,1} masks, exact, at 0, +-20 degrees and between."""
    r = np.random.RandomState(C)
    th = _angles()
    B = len(th)
    imgs = (r.rand(B, 32, 32, C) * 2 - 1).astype(np.float32)
    masks = (r.rand(B, 32, 32, C) > 0.7).astype(np.float32)
    for x in (imgs, masks):
        ref = np.asarray(jaugment.rotate_batch(jnp.asarray(x), jnp.asarray(th)))
        got = augment.rotate_batch(torch.from_numpy(x), torch.from_numpy(th)).numpy()
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        augment.rotate_batch(torch.from_numpy(imgs), torch.from_numpy(th))[0].numpy(), imgs[0])


def test_plain_nearest_warp_matches_pallas_kernel_interpret():
    """W*C = 128, as the Pallas kernel needs. Exact."""
    r = np.random.RandomState(3)
    B, H, W, C = 3, 16, 16, 8
    imgs = (r.rand(B, H, W, C) * 2 - 1).astype(np.float32)
    masks = (r.rand(B, H, W, C) > 0.7).astype(np.float32)
    locs = augment.rotation_locations(torch.from_numpy(_angles()[:B]), H, W)
    for x in (imgs, masks):
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(nearest_warp_pallas(jnp.asarray(x), jnp.asarray(locs.numpy()),
                                                 block_points=128))
        got = augment._nearest_warp_plain(torch.from_numpy(x), locs).numpy()
        np.testing.assert_array_equal(got, ref)


def test_random_rotate_batch_matches_jax():
    """Concatenate along channels, rotate once, split: the same arrays as
    the JAX package's for the angles its key draws."""
    key = jax.random.PRNGKey(5)
    r = np.random.RandomState(5)
    arrays = [r.rand(3, 32, 32, 1).astype(np.float32),
              (r.rand(3, 32, 32, 4) > 0.5).astype(np.float32)]
    ref = jaugment.random_rotate_batch(key, [jnp.asarray(a) for a in arrays], 20.0)
    th = np.array(jaugment.random_rotation_angles(key, 3, 20.0))
    got = augment.random_rotate_batch([torch.from_numpy(a) for a in arrays],
                                      torch.from_numpy(th))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_random_rotation_angles_range():
    g = torch.Generator().manual_seed(0)
    a = augment.random_rotation_angles(g, 4096, 20.0)
    assert a.shape == (4096,) and a.dtype == torch.float32
    lim = 20.0 * np.pi / 180.0
    assert float(a.min()) >= -lim and float(a.max()) < lim
    assert float(a.min()) < -0.9 * lim and float(a.max()) > 0.9 * lim


def test_nearest_warp_wrapper_refuses_cpu_tensors():
    vol = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.nearest_warp(vol, torch.zeros(1, 16, 2))


# -------------------------------------------------------- warp backward

def _bwd_inputs(B=2, H=16, W=16, C=8, seed=11, scale=0.05):
    r = np.random.RandomState(seed)
    vol = r.rand(B, H, W, C).astype(np.float32)
    off = ((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)
    g = r.randn(B, H, W, C).astype(np.float32)
    locs = np.asarray(jtps.tps_sample_locations(jnp.asarray(off), (H, W)))
    return vol, off, g, locs


@pytest.mark.parametrize("scale", [0.05, 1.2])
def test_plain_warp_bwd_matches_pallas_kernel_interpret(scale):
    """5e-5 abs / 1e-4 rel, as tests/test_pallas.py holds the kernel to the
    jnp path. Both see the same locations, so no floor() flips; at 1.2 some
    points fall outside and contribute nothing."""
    vol, _, g, locs = _bwd_inputs(scale=scale)
    with pltpu.force_tpu_interpret_mode():
        ref_v, ref_l = tps_bilinear_warp_bwd_pallas(
            jnp.asarray(vol), jnp.asarray(locs), jnp.asarray(g), block_points=128)
    got_v, got_l = tps._tps_warp_bwd_plain(torch.from_numpy(vol), torch.from_numpy(locs),
                                           torch.from_numpy(g))
    assert got_v.shape == vol.shape and got_l.shape == locs.shape
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=5e-5, rtol=1e-4)


def test_plain_warp_bwd_matches_jax_autodiff():
    """JAX autodiff of the jnp bilinear gather, same locations."""
    from multimodal_segmentation_tpu.ops.resample import bilinear_sample as jbilinear

    vol, _, g, locs = _bwd_inputs(seed=12)
    B, H, W, C = vol.shape

    def f(v, l):
        return jnp.sum(jax.vmap(jbilinear)(v, l) * jnp.asarray(g).reshape(B, H * W, C))

    ref_v, ref_l = jax.grad(f, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(locs))
    got_v, got_l = tps._tps_warp_bwd_plain(torch.from_numpy(vol), torch.from_numpy(locs),
                                           torch.from_numpy(g))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=5e-5, rtol=1e-4)


def test_warp_gradients_match_jax_jnp_path():
    """Gradients of the whole plain warp (vol and offsets) against JAX's,
    as tests/test_pallas.py:85-105 holds its kernel path."""
    vol, off, _, _ = _bwd_inputs(seed=13)
    tgt = np.random.RandomState(14).rand(*vol.shape).astype(np.float32)
    ref = jax.grad(lambda v, o: jnp.mean((jtps.tps_warp(v, o) - tgt) ** 2), argnums=(0, 1))(
        jnp.asarray(vol), jnp.asarray(off))
    v = torch.from_numpy(vol).requires_grad_(True)
    o = torch.from_numpy(off).requires_grad_(True)
    torch.mean((tps.tps_warp(v, o) - torch.from_numpy(tgt)) ** 2).backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref[0]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(ref[1]), atol=5e-5, rtol=1e-4)


def test_plain_warp_offsets_gradient_against_float64():
    """The offsets' gradient of the plain warp against float64, at the shape
    of the card's test_tps_warp_gradient_on_the_card_matches_plain. It sums
    4,096 location gradients of either sign per sample through the f32 TPS
    chain, so the chain's roundoff sets its error: held within 2e-5 of the
    largest entry. The location gradients alone, pushed through the exact
    chain, within 2e-6. The readings are printed (pytest -s)."""
    B, H, W, C = 4, 64, 64, 8
    r = np.random.RandomState(0)
    vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32))
    off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * 0.05).astype(np.float32))
    w = torch.from_numpy(r.randn(B, H, W, C).astype(np.float32))
    o = off.clone().requires_grad_(True)
    torch.sum(tps._tps_warp_plain(vol, o) * w).backward()
    chain, ref, spread = offsets_gradient_reference(vol, off, w)
    _, gl = tps._tps_warp_bwd_plain(vol, tps.tps_sample_locations(off, (H, W)), w)
    top = ref.abs().max().item()
    read = {"locs_through_exact_chain": (chain(gl) - ref).abs().max().item() / top,
            "plain_path": (o.grad.double() - ref).abs().max().item() / top,
            "reference_max": top, "terms_over_result": spread}
    print("offsets gradient error / largest entry:", read)
    assert read["locs_through_exact_chain"] <= 2e-6
    assert read["plain_path"] <= 2e-5


def test_warp_bwd_wrapper_refuses_cpu_tensors():
    vol, _, g, locs = _bwd_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.tps_warp_bwd(torch.from_numpy(vol), torch.from_numpy(locs),
                                  torch.from_numpy(g))


# ------------------------------------------------------ spectral penalty

@pytest.mark.parametrize("shape", [(4, 4, 4, 8), (4, 4, 8, 16), (4, 4, 1, 64)])
def test_spectral_penalty_matches_jax(shape):
    """The torch OIHW weight goes through hwio_matrix; penalty and new u at
    1e-5 relative (three f32 power iterations)."""
    r = np.random.RandomState(sum(shape))
    k = (r.randn(*shape) * 0.1).astype(np.float32)
    u = r.uniform(-1, 1, (16 * shape[2], 1)).astype(np.float32)
    ref_p, ref_u = jspectral.spectral_penalty(jnp.asarray(k), jnp.asarray(u))
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got_p, got_u = spectral.spectral_penalty(spectral.hwio_matrix(w), torch.from_numpy(u))
    np.testing.assert_allclose(float(got_p), float(ref_p), rtol=1e-5)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(ref_u), atol=1e-6, rtol=1e-5)


def test_spectral_penalty_gradient_matches_jax():
    r = np.random.RandomState(2)
    k = (r.randn(4, 4, 4, 8) * 0.1).astype(np.float32)
    u = r.uniform(-1, 1, (64, 1)).astype(np.float32)
    ref = jax.grad(lambda k: jspectral.spectral_penalty(k, jnp.asarray(u))[0])(jnp.asarray(k))
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    spectral.spectral_penalty(spectral.hwio_matrix(w), torch.from_numpy(u))[0].backward()
    np.testing.assert_allclose(w.grad.numpy().transpose(2, 3, 1, 0), np.asarray(ref),
                               atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------- losses

def _masks(seed, B=3, hw=16, C=5):
    r = np.random.RandomState(seed)
    lab = r.randint(0, C, (B, hw, hw))
    true = (lab[..., None] == np.arange(C)).astype(np.float32)
    logits = r.randn(B, hw, hw, C).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return true, pred.astype(np.float32)


LOSSES = {
    "dice_coef_perbatch": lambda L, t, p: L.dice_coef_perbatch(t, p),
    "dice_loss": lambda L, t, p: L.dice_loss(t, p),
    "restricted_dice_loss": lambda L, t, p: L.restricted_dice_loss(t, p, 4),
    "reference_weighted_bce": lambda L, t, p: L._reference_weighted_bce(t, p),
    "combined_dice_bce": lambda L, t, p: L.combined_dice_bce(t, p, 4),
    "mae": lambda L, t, p: L.mae(t, p),
    "lsgan_fool": lambda L, t, p: L.lsgan_fool(p[..., 0, 0, :1]),
    "lsgan_disc": lambda L, t, p: L.lsgan_disc(p[..., 0, 0, :1], p[..., 1, 1, 1:2]),
    "ypred_loss": lambda L, t, p: L.ypred_loss(p[..., 0, 0, :1]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_training_loss_and_gradient_match_jax(name):
    """Value at 1e-5 relative, gradient w.r.t. the prediction at 1e-5
    relative to its largest entry."""
    true, pred = _masks(len(name))
    fn = LOSSES[name]

    def jf(p):
        return jnp.sum(fn(jlosses, jnp.asarray(true), p))

    ref = jf(jnp.asarray(pred))
    ref_g = np.asarray(jax.grad(jf)(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = torch.sum(fn(tlosses, torch.from_numpy(true), p))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), ref_g, atol=1e-5 * np.abs(ref_g).max(), rtol=0)


# ---------------------------------------------------------- model helpers

def test_add_residual_matches_jax():
    r = np.random.RandomState(0)
    m = (r.rand(2, 8, 8, 4) > 0.8).astype(np.float32)
    np.testing.assert_array_equal(tbase.add_residual(torch.from_numpy(m)).numpy(),
                                  np.asarray(jbase.add_residual(jnp.asarray(m))))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_subsample_pool_matches_jax(k):
    """The slot indices are what the JAX package draws with randint."""
    key = jax.random.PRNGKey(k)
    r = np.random.RandomState(k)
    variants = [r.rand(5, 4, 4, 2).astype(np.float32) for _ in range(k)]
    ref = np.asarray(jbase.subsample_pool(key, [jnp.asarray(v) for v in variants]))
    idx = np.asarray(jax.random.randint(key, (5,), 0, k)) if k > 1 else np.zeros(5)
    got = tbase.subsample_pool(torch.from_numpy(idx.astype(np.int64)),
                               [torch.from_numpy(v) for v in variants]).numpy()
    np.testing.assert_array_equal(got, ref)


def test_batch_stream_matches_jax():
    r = np.random.RandomState(0)
    arrays = {"a": r.rand(7, 3).astype(np.float32), "b": r.rand(7, 2).astype(np.float32)}
    js, ts = JBatchStream(arrays, 3, seed=4), BatchStream(arrays, 3, seed=4)
    for _ in range(6):
        j, t = next(js), next(ts)
        for k in arrays:
            np.testing.assert_array_equal(t[k], j[k])
