"""CPU parity of the port's ops (multimodal_segmentation_torch/ops) with the
JAX package's: batching, straight-through rounding, bilinear sampling, the
TPS coefficients, sample locations and the plain warp, which is also held
against the Pallas warp kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_segmentation_tpu.ops import batching as jbatching
from multimodal_segmentation_tpu.ops import tps as jtps
from multimodal_segmentation_tpu.ops.pallas_kernels import tps_bilinear_warp_pallas
from multimodal_segmentation_tpu.ops.resample import bilinear_sample as jbilinear
from multimodal_segmentation_tpu.ops.rounding import round_ste as jround_ste
from multimodal_segmentation_torch.ops import batching, tps
from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_fwd
from multimodal_segmentation_torch.ops.resample import bilinear_sample
from multimodal_segmentation_torch.ops.rounding import round_ste

torch.set_num_threads(1)


def _offsets(B, seed, scale=0.05):
    r = np.random.RandomState(seed)
    return ((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_interleave_roundtrip_matches_jax(K):
    r = np.random.RandomState(K)
    xs = [r.rand(4, 3, 5, 2).astype(np.float32) for _ in range(K)]
    ref = np.asarray(jbatching.batch_interleave([jnp.asarray(x) for x in xs]))
    got = batching.batch_interleave([torch.from_numpy(x) for x in xs])
    np.testing.assert_array_equal(got.numpy(), ref)
    back = batching.batch_deinterleave(got, K)
    for a, b in zip(back, xs):
        np.testing.assert_array_equal(a.numpy(), b)


def test_round_ste_half_even_matches_jnp_round():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, 0.50000006,
                  3.2, -0.7], np.float32)
    x = np.concatenate([x, np.random.RandomState(0).rand(64).astype(np.float32) * 4 - 2])
    got = round_ste(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jround_ste(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:6], [-2.0, -2.0, -0.0, 0.0, 2.0, 2.0])


def test_round_ste_identity_gradient():
    x = torch.from_numpy(np.random.RandomState(1).rand(256).astype(np.float32))
    x.requires_grad_(True)
    (round_ste(x) * 3.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full(256, 3.0, np.float32))


@pytest.mark.parametrize("dims", [(5, 5), (32, 32), (192, 160)])
def test_control_grid_matches_jax(dims):
    got = tps.control_grid(dims)
    assert got.is_contiguous()  # the kernel takes it as a plain pointer
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtps.control_grid(list(dims))))


def test_const_tps_inverse_matches_jax():
    np.testing.assert_allclose(
        tps._const_tps_inverse((5, 5)), jtps._const_tps_inverse((5, 5)), atol=1e-6
    )


def test_tps_coefficients_match_jax():
    """The (28x28) @ (28x2) product sums terms up to ~10 in f32, so two f32
    orders of summation differ by a few 1e-6 (the JAX result is 3.7e-6 from
    the float64 product at this seed): JAX at 1e-5, float64 at 2e-6."""
    off = _offsets(3, 0)
    ref = np.asarray(jtps.tps_coefficients(jnp.asarray(off)))
    got = tps.tps_coefficients(torch.from_numpy(off)).numpy()
    assert got.shape == (3, 28, 2)
    assert tps.tps_coefficients(torch.from_numpy(off)).is_contiguous()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    rhs = np.concatenate(
        [tps.control_grid((5, 5)).numpy()[None] + off, np.zeros((3, 3, 2), np.float32)], 1
    )
    exact = np.einsum("ij,bjk->bik", tps._const_tps_inverse((5, 5)).astype(np.float64), rhs)
    np.testing.assert_allclose(got, exact, atol=2e-6)


@pytest.mark.parametrize("hw", [(16, 16), (192, 192)])
def test_tps_sample_locations_match_jax(hw):
    off = _offsets(2, 1)
    ref = np.asarray(jtps.tps_sample_locations(jnp.asarray(off), hw))
    got = tps.tps_sample_locations(torch.from_numpy(off), hw).numpy()
    assert got.shape == (2, hw[0] * hw[1], 2)
    # 1e-4 px, plus the f32 rounding of coordinates up to 191 px (1 ulp
    # there is 1.5e-5 px; two summation orders differ by a few ulp)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-6)


def test_bilinear_sample_matches_jax_out_of_range_corners():
    r = np.random.RandomState(2)
    img = r.rand(2, 12, 10, 3).astype(np.float32)
    # coordinates well outside, on the border and inside
    coords = (r.rand(2, 200, 2).astype(np.float32) * np.array([16, 14], np.float32)
              - np.array([2.0, 2.0], np.float32))
    coords[:, :4] = [[-1.0, 0.0], [0.0, -0.5], [11.0, 9.0], [11.5, 9.5]]
    ref = np.asarray(jax.vmap(jbilinear)(jnp.asarray(img), jnp.asarray(coords)))
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _warp_inputs(B=2, H=16, W=16, C=8, seed=3):
    r = np.random.RandomState(seed)
    vol = r.rand(B, H, W, C).astype(np.float32)
    off = ((r.rand(B, 25, 2) - 0.5) * 0.05).astype(np.float32)
    return vol, off


def test_plain_warp_matches_jax_jnp_path():
    vol, off = _warp_inputs()
    ref = np.asarray(jtps.tps_warp(jnp.asarray(vol), jnp.asarray(off), use_pallas=False))
    got = tps.tps_warp(torch.from_numpy(vol), torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_plain_warp_matches_pallas_kernel_interpret():
    vol, off = _warp_inputs()
    wv = jtps.tps_coefficients(jnp.asarray(off))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(tps_bilinear_warp_pallas(
            jnp.asarray(vol), wv, jtps.control_grid([5, 5]), block_points=128))
    got = tps._tps_warp_plain(torch.from_numpy(vol), torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_plain_warp_large_offsets_zero_outside():
    vol, _ = _warp_inputs(seed=4)
    off = _offsets(2, 4, scale=1.2)
    ref = np.asarray(jtps.tps_warp(jnp.asarray(vol), jnp.asarray(off)))
    got = tps.tps_warp(torch.from_numpy(vol), torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)
    assert (got == 0).any()  # some points fall fully outside


def test_plain_warp_identity_offsets():
    vol, _ = _warp_inputs(seed=5)
    got = tps.tps_warp(torch.from_numpy(vol), torch.zeros(2, 25, 2)).numpy()
    np.testing.assert_allclose(got, vol, atol=2e-3)


def test_kernel_wrapper_refuses_cpu_tensors():
    vol, off = _warp_inputs()
    wv = tps.tps_coefficients(torch.from_numpy(off))
    with pytest.raises(ValueError, match="CUDA"):
        tps_warp_fwd(torch.from_numpy(vol), wv, tps.control_grid((5, 5)))
