"""The general TPS surface of the port (ops/tps.py: cp_dims, inverse, order)
against the JAX package's jnp route on the CPU, one parametrised test a
property over inverse x order x cp_dims:

  * tps_sample_locations at 32x32 (and two 64x64 cases, where the bounds
    scale with the pixel scale H - 1, 63 / 31): the forward
    mapping within 1e-4 px (one formula, f32 on both sides); the inverse
    within 1e-3 px: each side solves its (n+3)-square systems in f32 with
    another LU (torch's and XLA's), and JAX's own f32 inverse locations
    lie within ~5e-4 px of a float64 solve at 192^2, so the two f32 solves
    may part by about twice that (here each side lies within 2.1e-4 px of
    the port's float64 solve and they part by at most 1.8e-4 px);
  * tps_warp (the port's plain route) against tps_warp(use_pallas=False)
    on [0, 1] images, within the location bound (the image's values move
    by at most their step between neighbours, < 1, times the gap in px);
  * d loss / d cp_offsets of loss = sum(tps_warp(vol, off) * w) against
    jax.grad of the jnp route, within 1e-3 of the gradient's largest
    entry (forward) and 2e-2 (inverse: the solve's f32 roundoff enters the
    gradient through the adjoint solve, conditioned like the forward one).

The JAX package's Pallas route is never the reference here: it ignores
`inverse` and `order` (ops/tps.py:248-255 passes the regular grid as the
centres, ops/pallas_kernels.py:129 hard-codes the order-2 basis) and
differs from its jnp route by 0.87-0.99 on [0, 1] images where either is
not the default (32x32, C = 4, offsets sigma 0.03, interpret mode).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu.ops import tps as jtps
from multimodal_segmentation_torch.ops import tps

torch.set_num_threads(1)

CASES = [(inv, order, dims) for inv in (False, True) for order in (1, 2, 3, 4)
         for dims in ((5, 5), (4, 4), (6, 5))]
IDS = ["%s-order%d-%dx%d" % ("inverse" if c[0] else "forward", c[1], *c[2]) for c in CASES]
LOC_BOUND = {False: 1e-4, True: 1e-3}
GRAD_BOUND = {False: 1e-3, True: 2e-2}


def _inputs(inverse, order, dims, H=32, W=32, B=3, C=4):
    r = np.random.RandomState(7 * order + 3 * dims[0] + dims[1] + int(inverse))
    off = ((r.rand(B, dims[0] * dims[1], 2) - 0.5) * 0.06).astype(np.float32)
    vol = r.rand(B, H, W, C).astype(np.float32)
    w = r.randn(B, H, W, C).astype(np.float32)
    return off, vol, w


@functools.lru_cache(maxsize=None)
def _jax_case(inverse, order, dims, H, W):
    """The JAX package's jnp route: (locations, warp, d loss / d offsets)."""
    off, vol, w = _inputs(inverse, order, dims, H, W)

    def loss(o):
        return jnp.sum(jtps.tps_warp(jnp.asarray(vol), o, dims, inverse, order) * w)

    o = jnp.asarray(off)
    locs = jtps.tps_sample_locations(o, (H, W), dims, inverse, order)
    warped = jtps.tps_warp(jnp.asarray(vol), o, dims, inverse, order, use_pallas=False)
    return np.asarray(locs), np.asarray(warped), np.asarray(jax.grad(loss)(o))


def _port_case(inverse, order, dims, H, W):
    off, vol, w = _inputs(inverse, order, dims, H, W)
    o = torch.from_numpy(off).requires_grad_(True)
    locs = tps.tps_sample_locations(o.detach(), (H, W), dims, inverse, order)
    warped = tps.tps_warp(torch.from_numpy(vol), o, dims, inverse, order)
    (warped * torch.from_numpy(w)).sum().backward()
    return locs.numpy(), warped.detach().numpy(), o.grad.numpy()


@pytest.mark.parametrize("inverse,order,dims", CASES, ids=IDS)
def test_sample_locations_match_jax(inverse, order, dims):
    got = tps.tps_sample_locations(torch.from_numpy(_inputs(inverse, order, dims)[0]),
                                   (32, 32), dims, inverse, order).numpy()
    ref = _jax_case(inverse, order, dims, 32, 32)[0]
    gap = np.abs(got - ref).max()
    assert got.shape == ref.shape == (3, 32 * 32, 2)
    assert gap <= LOC_BOUND[inverse], "largest gap %.3g px" % gap


@pytest.mark.parametrize("inverse,order,dims", [(True, 2, (5, 5)), (False, 3, (6, 5))],
                         ids=["inverse-order2-5x5", "forward-order3-6x5"])
def test_sample_locations_match_jax_64(inverse, order, dims):
    got = _port_case(inverse, order, dims, 64, 64)[0]
    ref = _jax_case(inverse, order, dims, 64, 64)[0]
    gap = np.abs(got - ref).max()
    assert gap <= LOC_BOUND[inverse] * 63 / 31, "largest gap %.3g px" % gap


@pytest.mark.parametrize("inverse,order,dims", CASES, ids=IDS)
def test_warp_and_offset_gradient_match_jax(inverse, order, dims):
    _, warped, grad = _port_case(inverse, order, dims, 32, 32)
    _, ref_warped, ref_grad = _jax_case(inverse, order, dims, 32, 32)
    assert np.abs(warped - ref_warped).max() <= LOC_BOUND[inverse]
    top = np.abs(ref_grad).max()
    gap = np.abs(grad - ref_grad).max()
    assert top > 0 and gap <= GRAD_BOUND[inverse] * top, "gradient gap %.3g of %.3g" % (gap, top)


@pytest.mark.parametrize("inverse,order,dims", [(False, 2, (4, 4)), (True, 3, (5, 5)),
                                                (True, 4, (6, 5)), (False, 1, (5, 5))],
                         ids=["forward-order2-4x4", "inverse-order3-5x5", "inverse-order4-6x5",
                              "forward-order1-5x5"])
def test_general_kernel_plain_version_matches_the_warp(inverse, order, dims):
    """The plain version of the kernel's general entry (float64 flow with
    direct differences, from the f32 coefficients and centres) against the
    CPU route (f32, expanded-form distances): within 2e-4 on [0, 1]
    images at 32x32; the kernel itself is held to it on the card."""
    off, vol, _ = _inputs(inverse, order, dims)
    o, v = torch.from_numpy(off), torch.from_numpy(vol)
    got = tps._tps_warp_general_plain(v, tps.tps_coefficients(o, dims, inverse, order),
                                      tps.tps_centres(o, dims, inverse), order)
    ref = tps._tps_warp_plain(v, o, dims, inverse, order)
    assert np.abs(got.numpy() - ref.numpy()).max() <= 2e-4


def test_cuda_route_refuses_more_than_32_control_points():
    """The kernel takes at most 32 control points, as the JAX kernel pads
    to 32: a 6x6 grid on a CUDA tensor raises before anything is built (a
    stand-in with a CUDA device: the check reads the device only). The
    plain route on the CPU takes any grid."""
    on_card = type("OnCard", (), {"device": torch.device("cuda")})()
    with pytest.raises(ValueError, match="at most 32"):
        tps.tps_warp(on_card, torch.zeros(1, 36, 2), (6, 6))
    got = tps.tps_warp(torch.rand(1, 8, 8, 1), torch.zeros(1, 36, 2), (6, 6))
    assert got.shape == (1, 8, 8, 1)


# ---------------------------------------- the general entry's float64 log

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "multimodal_segmentation_torch", "csrc", "tps_warp.cu")
LOG_BITS = 7                      # kLogBits: 2^7 bins of the mantissa
LN2 = 0.6931471805599453          # kLn2
TAYLOR = (-1.0 / 6.0, 0.2, -0.25, 1.0 / 3.0, -0.5)   # Horner, degree 6 down to 2


def _two_prod(a, b):
    """a * b as p + e exactly (Dekker's product)."""
    def split(x):
        t = 134217729.0 * x
        hi = t - (t - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """fma(a, b, c) from the exact product: p + c with its error, then the
    product's error; exact where p + c is (the reduction's fma(m, 1/c_j,
    -1): p is within 2^-7 of 1), else within an ulp of one rounding."""
    p, e = _two_prod(a, b)
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + e)


def _log_model(x):
    """numpy model of csrc/tps_warp.cu::log_reduced on float64 x > 0
    (normal): the same table (2^LOG_BITS bins, c_j = 1 + (j + 0.5) /
    2^LOG_BITS, entries 1/c_j and -log(1/c_j)), the same bit operations and
    the same float64 operations in the same order, fma included."""
    bits = x.view(np.uint64)
    hi = (bits >> np.uint64(32)).astype(np.int64)
    j = (hi >> (20 - LOG_BITS)) & ((1 << LOG_BITS) - 1)
    inv = 1.0 / (1.0 + (np.arange(1 << LOG_BITS) + 0.5) / (1 << LOG_BITS))
    t_inv, t_log = inv[j], -np.log(inv)[j]
    m = ((bits & np.uint64(0x000FFFFFFFFFFFFF)) | np.uint64(0x3FF0000000000000)).view(np.float64)
    k = ((np.uint64(0x43300000) << np.uint64(32)) | (hi >> 20).astype(np.uint64)).view(
        np.float64) - 4503599627371519.0
    r = _fma(m, t_inv, -1.0)
    p = _fma(r, TAYLOR[0], TAYLOR[1])
    for c in TAYLOR[2:]:
        p = _fma(r, p, c)
    p = _fma(r * r, p, r)
    return _fma(k, LN2, t_log + p), r


def test_reduced_range_log_matches_numpy():
    """The float64 log of B1's general entry (csrc/tps_warp.cu::
    log_reduced, constants kLogBits, kLn2 and the degree-6 Taylor
    polynomial, which this model mirrors and reads back from the source)
    against np.log on 10^6 log-spaced points in [1e-10, 8] (the clamped
    squared distances it takes) and on every table bin's edges, each with
    its neighbours an ulp away: within 1e-14 absolute (3 ulps of log 1e-10;
    the model is within 3.6e-15, and 5 bits of table would miss by
    3.2e-14), with |r| <= 2^-8."""
    src = open(KERNEL_SOURCE).read()
    assert "constexpr int kLogBits = %d;" % LOG_BITS in src
    assert "constexpr double kLn2 = %r;" % LN2 in src
    assert "fma(r, -1.0 / 6.0, 0.2)" in src and "fma(r * r, p, r)" in src
    edges = np.array([2.0 ** e * (1 + j / 2 ** LOG_BITS) for e in range(-34, 4)
                      for j in range(2 ** LOG_BITS + 1)])
    edges = np.concatenate([edges, np.nextafter(edges, 0), np.nextafter(edges, np.inf)])
    x = np.concatenate([np.logspace(-10, np.log10(8.0), 10 ** 6),
                        edges[(edges >= 1e-10) & (edges <= 8.0)]])
    got, r = _log_model(x)
    assert np.abs(r).max() <= 2.0 ** -8
    gap = np.abs(got - np.log(x)).max()
    assert gap <= 1e-14, "largest gap %.3g" % gap
