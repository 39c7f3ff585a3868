"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the training step at full width. JAX-free, because the
card's machine has no JAX and tests/conftest.py imports it; run there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips."""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_segmentation_torch.config import (
    cardiac_3d,
    dafnet_chaos,
    mmsdnet_chaos,
    tiny_test_config,
)
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.nn import blocks
from multimodal_segmentation_torch.ops import augment, cuda_kernels, epilogue, same_conv, thin_conv, tps
from multimodal_segmentation_torch.ops.resample import bilinear_sample
from multimodal_segmentation_torch.train import (
    DAFNetSteps,
    create_train_state,
    draw_mmsdnet_disc_noise,
    draw_mmsdnet_noise,
    draw_noise,
    make_steps,
)
from multimodal_segmentation_torch.utils import tracing
from torch_warp_reference import offsets_gradient_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, B=3, H=64, W=48, C=8, scale=0.05, seed=0, dtype=torch.float32):
    r = np.random.RandomState(seed)
    vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(device, dtype)
    off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)).to(device)
    return vol, off


def _kernel_and_plain(vol, off):
    wv = tps.tps_coefficients(off)
    got = cuda_kernels.tps_warp_fwd(vol, wv, tps.control_grid((5, 5), vol.device))
    ref = tps._tps_warp_plain(vol, off)
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.parametrize("scale", [0.0, 0.05, 0.6])
def test_warp_kernel_matches_plain_f32(cuda, scale):
    got, ref = _kernel_and_plain(*_inputs(cuda, scale=scale))
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("scale", [0.05, 0.6])
def test_warp_kernel_matches_plain_bf16(cuda, scale):
    got, ref = _kernel_and_plain(*_inputs(cuda, scale=scale, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


def test_warp_kernel_inference_shape(cuda):
    got, ref = _kernel_and_plain(*_inputs(cuda, B=24, H=192, W=192, C=8))
    assert (got - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("B", [1, 5, 13, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 3, 8, 16])
def test_warp_kernel_image_and_channel_counts(cuda, B, dtype, C):
    """Image counts that do not fill a chunk of 8 (1, 5, 13) and one that
    does (24); C = 8 and 16 (16-byte loads: one or two a corner kept in
    registers, or, for 64-byte f32 rows, four read in the blend), 1 and 3
    (rows of 4, 12, 2 or 6 bytes: a channel at a time)."""
    got, ref = _kernel_and_plain(*_inputs(cuda, B=B, H=40, W=36, C=C, scale=0.3, seed=B,
                                          dtype=dtype))
    assert got.dtype == dtype and got.shape == (B, 40, 36, C)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_points_outside(cuda, dtype):
    """The training shape with offsets of +-0.04 (chip_smoke.py's "large"
    case): some points fall fully outside and are written as zeros."""
    got, ref = _kernel_and_plain(*_inputs(cuda, B=12, H=192, W=192, C=8, scale=0.08, seed=3,
                                          dtype=dtype))
    outside = (ref == 0).all(-1)
    assert outside.any() and (got[outside] == 0).all()
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_warp_kernel_unaligned_rows(cuda):
    """A view 4 bytes into its storage is not 16-byte aligned: the kernel
    reads it a channel at a time, with the same result."""
    vol, off = _inputs(cuda, B=3, H=40, W=36, C=8)
    shifted = torch.empty(vol.numel() + 1, device=cuda)[1:].view(vol.shape)
    shifted.copy_(vol)
    wv, cp = tps.tps_coefficients(off), tps.control_grid((5, 5), cuda)
    assert torch.equal(cuda_kernels.tps_warp_fwd(shifted, wv, cp),
                       cuda_kernels.tps_warp_fwd(vol, wv, cp))


def test_launch_counter_counts_kernel_launches(cuda):
    vol, off = _inputs(cuda)
    before = cuda_kernels.TPS_WARP_FWD.launches
    tps.tps_warp(vol, off)
    tps.tps_warp(vol, off)
    assert cuda_kernels.TPS_WARP_FWD.launches == before + 2


def test_predict_mask_launches_kernel_for_warped_fusions(cuda):
    model = build_model(tiny_test_config(), device="cuda")
    x = np.random.RandomState(1).rand(2, 32, 32, 1).astype(np.float32)
    for fusion, launched in (("simple", 0), ("def", 1), ("max", 1), ("maxnostn", 0)):
        before = cuda_kernels.TPS_WARP_FWD.launches
        m = model.predict_mask(1, fusion, [x, x], device="cuda")
        assert m.shape == (2, 32, 32, 5) and torch.isfinite(m).all()
        assert cuda_kernels.TPS_WARP_FWD.launches == before + launched


def test_wrapper_rejects_bad_inputs(cuda):
    vol, off = _inputs(cuda)
    wv = tps.tps_coefficients(off)
    cp = tps.control_grid((5, 5), cuda)
    bad = [
        (vol.half(), wv, cp),                          # dtype
        (vol[0], wv, cp),                              # not 4-D
        (vol, wv[:, :27], cp),                         # wv shape
        (vol, wv, cp[:24]),                            # cp shape
        (vol, wv.double(), cp),                        # wv dtype
        (vol.transpose(1, 2), wv, cp),                 # not contiguous
        (vol.cpu(), wv, cp),                           # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_kernels.tps_warp_fwd(*args)


# --------------------------------------------------- flow-stage dump (B5)

def _flow_inputs(device, B, scale=0.05, seed=0):
    r = np.random.RandomState(seed)
    off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)).to(device)
    return off, tps.tps_coefficients(off), tps.control_grid((5, 5), device)


@pytest.mark.parametrize("B,H,W", [(2, 192, 192), (12, 192, 192), (3, 33, 47)])
def test_flow_kernel_matches_plain(cuda, B, H, W):
    """B5 against its plain version (the same formula and order, in torch
    on the card) at the tool's shape, the training shape and an odd one:
    qy, qx and phi_0 within 1e-6; the flow within 2e-4 px at offsets of
    +-0.025 and within 1e-3 px at +-0.3, whose ~10x larger coefficients
    scale the f32 roundoff of the sum (2.9e-4 px from float64 for the
    plain version at 192x192 on the CPU); tps_flow_stage launches it."""
    for scale, tol in ((0.05, 2e-4), (0.6, 1e-3)):
        _, wv, cp = _flow_inputs(cuda, B, scale)
        before = cuda_kernels.TPS_FLOW_DBG.launches
        got = tps.tps_flow_stage(wv, cp, (H, W))
        assert cuda_kernels.TPS_FLOW_DBG.launches == before + 1
        ref = tps._tps_flow_stage_plain(wv, cp, (H, W))
        torch.cuda.synchronize()
        assert got.shape == (B, H * W, 5) and got.dtype == torch.float32
        err = (got - ref).abs().amax((0, 1)).tolist()
        assert err[0] <= tol and err[1] <= tol, (scale, err)
        assert max(err[2:]) <= 1e-6, (scale, err)


def test_flow_kernel_and_warp_kernel_share_the_flow(cuda):
    """B1's output is a bilinear blend at B5's locations, to f32 roundoff
    of the blend (1e-5 on inputs in [0, 1]), at the training shape (B =
    12) and the inference shape (B = 24): a flow that differed at all would
    flip floor() at pixel edges and move the output by the image's
    gradient."""
    H, W, C = 192, 192, 8
    for B in (12, 24):
        off, wv, cp = _flow_inputs(cuda, B)
        vol = torch.from_numpy(np.random.RandomState(1).rand(B, H, W, C).astype(np.float32))
        vol = vol.to(cuda)
        locs = cuda_kernels.tps_flow_dbg(wv, cp, (H, W))[..., :2].contiguous()
        warped = cuda_kernels.tps_warp_fwd(vol, wv, cp)
        blended = bilinear_sample(vol, locs).reshape(B, H, W, C)
        torch.cuda.synchronize()
        assert (warped - blended).abs().max().item() <= 1e-5, B


def test_flow_wrapper_rejects_bad_inputs(cuda):
    _, wv, cp = _flow_inputs(cuda, 2)
    bad = [
        (wv.cpu(), cp, (8, 8)),                        # device
        (wv[:, :27], cp, (8, 8)),                      # wv shape
        (wv[0], cp, (8, 8)),                           # wv not 3-D
        (wv.double(), cp, (8, 8)),                     # wv dtype
        (wv.transpose(1, 2).contiguous().transpose(1, 2), cp, (8, 8)),  # not contiguous
        (wv, cp[:24], (8, 8)),                         # cp shape
        (wv, cp.cpu(), (8, 8)),                        # cp device
        (wv, cp, (1, 8)),                              # H < 2
        (wv, cp, (8, 2 ** 31)),                        # H * W past int32
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_kernels.tps_flow_dbg(*args)


def test_built_library_goes_stale_with_a_newer_flow_header(cuda, tmp_path, monkeypatch):
    """The library built on the card is fresh; a copy of csrc/ whose shared
    header tps_flow.cuh is newer than it makes it stale."""
    cuda_kernels.TPS_FLOW_DBG.fn()
    assert not cuda_kernels._stale()
    built = os.path.getmtime(cuda_kernels.LIBRARY)
    for f in os.listdir(cuda_kernels.CSRC_DIR):
        shutil.copy(os.path.join(cuda_kernels.CSRC_DIR, f), tmp_path / f)
        os.utime(tmp_path / f, (built - 10, built - 10))
    monkeypatch.setattr(cuda_kernels, "CSRC_DIR", str(tmp_path))
    assert not cuda_kernels._stale()
    os.utime(tmp_path / "tps_flow.cuh", (built + 10, built + 10))
    assert cuda_kernels._stale()


# ------------------------------------------------------- warp backward (B2)

def _bwd_inputs(device, B=3, H=64, W=48, C=8, scale=0.05, seed=0, dtype=torch.float32):
    vol, off = _inputs(device, B, H, W, C, scale, seed, dtype)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(B, H, W, C).astype(np.float32))
    locs = tps.tps_sample_locations(off, (H, W))
    return vol, locs, g.to(device, dtype)


@pytest.mark.parametrize("scale", [0.05, 0.6])
def test_warp_bwd_kernel_matches_plain_f32(cuda, scale):
    """grad_locs at 5e-5 abs / 1e-4 rel; grad_vol within 1e-5 of its
    largest entry (f32 atomics sum in a run-dependent order)."""
    vol, locs, g = _bwd_inputs(cuda, scale=scale)
    gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, g)
    rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
    torch.cuda.synchronize()
    assert gv.dtype == torch.float32 and gl.shape == locs.shape
    torch.testing.assert_close(gl, rl, atol=5e-5, rtol=1e-4)
    assert (gv - rv).abs().max().item() <= 1e-5 * rv.abs().max().item()


def test_warp_bwd_kernel_matches_plain_bf16(cuda):
    vol, locs, g = _bwd_inputs(cuda, dtype=torch.bfloat16)
    gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, g)
    rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
    torch.cuda.synchronize()
    assert gv.dtype == torch.bfloat16
    assert (gv.float() - rv.float()).abs().max().item() <= 3e-2
    scale = rl.abs().max().item() + 1e-6
    assert (gl - rl).abs().max().item() / scale <= 3e-2


def test_warp_bwd_kernel_training_shape(cuda):
    vol, locs, g = _bwd_inputs(cuda, B=12, H=192, W=192, C=8)
    gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, g)
    rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
    torch.testing.assert_close(gl, rl, atol=5e-5, rtol=1e-4)
    assert (gv - rv).abs().max().item() <= 1e-5 * rv.abs().max().item()


def _bwd_check(vol, locs, g):
    """The kernel against its plain version, f32 tolerances (as above)."""
    gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, g)
    rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(gl, rl, atol=5e-5, rtol=1e-4)
    assert (gv - rv).abs().max().item() <= 1e-5 * rv.abs().max().item()


def test_warp_bwd_kernel_scattered_locations(cuda):
    """Locations uniform over [-2, H+1) x [-2, W+1): no tile's corners fit
    a shared-memory window, so every corner goes to a global atomic; some
    points fall outside the image."""
    vol, locs, g = _bwd_inputs(cuda, B=4, H=96, W=80)
    r = np.random.RandomState(7)
    lo, hi = np.array([-2.0, -2.0]), np.array([96 + 1.0, 80 + 1.0])
    locs = torch.from_numpy((lo + r.rand(4, 96 * 80, 2) * (hi - lo)).astype(np.float32)).to(cuda)
    _bwd_check(vol, locs, g)


@pytest.mark.parametrize("stretch", [2.5, 2.7, 6.0])
def test_warp_bwd_kernel_window_edges(cuda, stretch):
    """x = stretch * j + 0.6: a 32-point tile row spans ~32 * stretch
    columns, so its C = 8 window fits (2.5), just does not (2.7: part of the
    tile goes to global atomics) or holds a small part (6.0); columns past
    W fall outside. Rows sit on the last row and just past it too."""
    B, H, W, C = 2, 40, 200, 8
    vol, _, g = _bwd_inputs(cuda, B=B, H=H, W=W, C=C)
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    y = np.where(i % 9 == 0, H - 1.0, np.where(i % 9 == 1, -1.0, i + 0.3))
    locs = np.stack([y, stretch * j + 0.6], -1).reshape(1, H * W, 2)
    _bwd_check(vol, torch.from_numpy(np.repeat(locs, B, 0).astype(np.float32)).to(cuda), g)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_warp_bwd_kernel_channel_counts(cuda, C):
    """The window's flush in float4 (C % 4 == 0), float2 and scalar
    atomics, with small and large TPS offsets."""
    for scale in (0.05, 0.6):
        _bwd_check(*_bwd_inputs(cuda, B=2, H=64, W=48, C=C, scale=scale))


def test_warp_bwd_kernel_reads_g_through_its_strides(cuda):
    """g as the fuser hands it over (an NCHW tensor through permute) and a
    g with a gap between pixels give what the contiguous g gives."""
    vol, locs, g = _bwd_inputs(cuda, B=3, H=64, W=48, C=8)
    ref_v, ref_l = cuda_kernels.tps_warp_bwd(vol, locs, g)
    wide = torch.zeros(3, 64, 48, 11, device=cuda)
    wide[..., 2:10] = g
    for gg in (g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), wide[..., 2:10]):
        assert not gg.is_contiguous()
        gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, gg)
        torch.cuda.synchronize()
        assert torch.equal(gl, ref_l)
        assert (gv - ref_v).abs().max().item() <= 1e-6 * ref_v.abs().max().item()
    _bwd_check(vol, locs, g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))


def test_warp_bwd_kernel_outside_and_nan_points_contribute_nothing(cuda):
    vol, locs, g = _bwd_inputs(cuda, B=1, H=8, W=8, C=2)
    locs = locs.clone()
    locs[0, 0] = torch.tensor([float("nan"), 3.0])
    locs[0, 1] = torch.tensor([-1.5, 3.0])
    locs[0, 2] = torch.tensor([2.0, 8.0])
    locs[0, 3] = torch.tensor([1e30, -1e30])
    gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, g)
    torch.cuda.synchronize()
    assert torch.isfinite(gv).all()
    assert (gl[0, :4] == 0).all()


def test_tps_warp_gradient_on_the_card_matches_plain(cuda):
    """The autograd Function (kernel forward, kernel backward, autograd
    chain to the offsets) against autograd of the plain warp and against a
    float64 reference. The loss is linear in the warp's output, so every
    backward gets the same cotangent (the two forwards differ by up to
    2e-4); grad_vol then differs only as the backward kernel and its plain
    version do, within 1e-5 of its largest entry.

    The offsets' gradient sums 4,096 location gradients of either sign per
    sample through the f32 TPS chain (autograd of tps_sample_locations),
    which both paths share; the sum is ~10x smaller than the sum of its
    terms' magnitudes. So it is checked in parts (tests/torch_warp_reference.py):
      * the kernel's own share, its location gradient pushed through the
        exact float64 chain: 7.5e-8 of the largest entry on the H100, held
        at 2e-6;
      * the Function's wiring: its gradient against the same f32 chain
        applied to the kernel's location gradient, the same operations,
        held at 1e-6;
      * the two paths against each other: 9.6e-6 on the H100, held at 2e-5;
      * each path against float64: the f32 chain's own roundoff, 3.1e-5 of
        the largest entry on the H100 for either path (5.7e-6 on the CPU,
        tests/test_torch_train_ops.py::test_plain_warp_offsets_gradient_
        against_float64), held at 1e-4.
    The readings are printed (pytest -s)."""
    B, H, W, C = 4, 64, 64, 8
    vol, off = _inputs(cuda, B=B, H=H, W=W, C=C)
    w = torch.randn(vol.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    grads = []
    for fn in (tps.tps_warp, tps._tps_warp_plain):
        v = vol.clone().requires_grad_(True)
        o = off.clone().requires_grad_(True)
        torch.sum(fn(v, o) * w).backward()
        grads.append((v.grad, o.grad))
    before = cuda_kernels.TPS_WARP_BWD.launches
    v = vol.clone().requires_grad_(True)
    o = off.clone().requires_grad_(True)
    # the cotangent reaches the Function through a permute, as in the fuser
    tps.tps_warp(v, o).permute(0, 3, 1, 2).sum().backward()
    assert cuda_kernels.TPS_WARP_BWD.launches == before + 1
    (kv, ko), (pv, po) = grads

    chain, ref, spread = offsets_gradient_reference(vol, off, w)
    top = ref.abs().max().item()
    with torch.enable_grad():
        o = off.clone().requires_grad_(True)
        locs = tps.tps_sample_locations(o, (H, W))
    _, gl_k = cuda_kernels.tps_warp_bwd(vol, locs.detach(), w)
    (f32_chain,) = torch.autograd.grad(locs, o, gl_k)
    read = {
        "kernel_locs_through_exact_chain": (chain(gl_k) - ref).abs().max().item() / top,
        "function_vs_f32_chain": (ko - f32_chain).abs().max().item() / top,
        "kernel_vs_plain": (ko - po).abs().max().item() / po.abs().max().item(),
        "kernel_path": (ko.double() - ref).abs().max().item() / top,
        "plain_path": (po.double() - ref).abs().max().item() / top,
        "reference_max": top,
        "terms_over_result": spread,
    }
    print("offsets gradient error / largest entry:", read)
    assert (kv - pv).abs().max().item() <= 1e-5 * pv.abs().max().item()
    assert read["kernel_locs_through_exact_chain"] <= 2e-6
    assert read["function_vs_f32_chain"] <= 1e-6
    assert read["kernel_vs_plain"] <= 2e-5
    assert read["kernel_path"] <= 1e-4 and read["plain_path"] <= 1e-4


# -------------------------------------------------------- nearest warp (B3)

@pytest.mark.parametrize("C", [10, 8, 2])
def test_nearest_warp_kernel_bit_exact(cuda, C):
    """Images and {0,1} masks, at the training shape, bit for bit."""
    r = np.random.RandomState(C)
    th = torch.from_numpy(np.radians(np.array([0.0, 20.0, -20.0, 7.3, -13.9, 19.99],
                                              np.float32))).to(cuda)
    for x in ((r.rand(6, 192, 192, C) * 2 - 1), (r.rand(6, 192, 192, C) > 0.7)):
        vol = torch.from_numpy(x.astype(np.float32)).to(cuda)
        locs = augment.rotation_locations(th, 192, 192)
        got = cuda_kernels.nearest_warp(vol, locs)
        ref = augment._nearest_warp_plain(vol, locs)
        assert torch.equal(got, ref)
        assert torch.equal(got[0], vol[0])


def test_nearest_warp_kernel_bf16_and_clamping(cuda):
    vol = torch.rand(2, 16, 12, 3, device=cuda).to(torch.bfloat16)
    locs = (torch.rand(2, 16 * 12, 2, device=cuda) * 40 - 10)
    locs[0, 0] = torch.tensor([2.5, 3.5])   # ties round half to even: (2, 4)
    got = cuda_kernels.nearest_warp(vol, locs)
    assert torch.equal(got, augment._nearest_warp_plain(vol, locs))
    assert torch.equal(got[0, 0, 0], vol[0, 2, 4])


def _tie_angles(device, n):
    """n f32 angles whose sin or cos on `device` is exactly +-0.5: on an
    odd-sized image they put locations on exact .5 ties."""
    found = []
    for deg in (30.0, -30.0, 60.0, -60.0):
        t = np.float32(np.radians(deg))
        cand = (np.array([t]).view(np.int32) + np.arange(-256, 257, dtype=np.int32)).view(np.float32)
        tt = torch.from_numpy(cand).to(device)
        hit = ((torch.sin(tt).abs() == 0.5) | (torch.cos(tt).abs() == 0.5)).cpu().numpy()
        found += [float(a) for a in cand[hit][:1]]
    assert len(found) >= 2
    return torch.tensor((found * n)[:n], dtype=torch.float32, device=device)


# the step's groups (automated pairing's 3 + 3 + 4 + 4 among them) and odd ones
GROUPS = ([1, 1, 4, 4], [3, 3, 4, 4], [1, 1, 4], [4, 4], [1, 1], [3], [2, 5, 1, 7])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", GROUPS)
def test_rotate_group_kernel_bit_exact(cuda, dtype, widths):
    """The fused group rotation, images and {0,1} masks, against the group
    concatenated, sampled at rotation_locations and split (the CPU path and
    the JAX package's way), and against its own plain version: at 0, +-20
    degrees and between on 192x192, and at tie angles on 33x33."""
    r = np.random.RandomState(sum(widths))
    th20 = torch.from_numpy(np.radians(np.array([0.0, 20.0, -20.0, 7.3, -13.9, 19.99],
                                                np.float32))).to(cuda)
    for B, H, W, th in ((6, 192, 192, th20), (4, 33, 33, _tie_angles(cuda, 4))):
        cos_t, sin_t = torch.cos(th), torch.sin(th)
        locs = augment.rotation_locations(th, H, W)
        if H == 33:
            assert ((locs - locs.floor()) == 0.5).any()
        for masks in (False, True):
            arrays = [torch.from_numpy(((r.rand(B, H, W, c) > 0.7) if masks else
                                        (r.rand(B, H, W, c) * 2 - 1)).astype(np.float32))
                      .to(cuda, dtype) for c in widths]
            cat = augment._nearest_warp_plain(torch.cat(arrays, -1), locs)
            ref = torch.split(cat, widths, -1)
            for got in (cuda_kernels.rotate_group(arrays, cos_t, sin_t),
                        augment._rotate_group_plain(arrays, cos_t, sin_t)):
                assert all(torch.equal(a, b) for a, b in zip(got, ref))
            if H == 192:   # sample 0 at 0 degrees: the identity
                assert torch.equal(cuda_kernels.rotate_group(arrays, cos_t, sin_t)[0][0],
                                   arrays[0][0])


def test_random_rotate_batch_group_sizes_on_the_card(cuda):
    """random_rotate_batch launches one rotate_group per 4 arrays and
    returns the arrays in order, bit-exact against the concatenated
    reference."""
    r = np.random.RandomState(3)
    th = torch.from_numpy(np.radians(np.array([11.0, -17.5, 3.2], np.float32))).to(cuda)
    arrays = [torch.from_numpy(r.rand(3, 40, 36, c).astype(np.float32)).to(cuda)
              for c in (1, 4, 2, 1, 4, 3)]
    before = cuda_kernels.NEAREST_WARP.launches
    got = augment.random_rotate_batch(arrays, th)
    assert cuda_kernels.NEAREST_WARP.launches == before + 2
    ref = torch.split(augment._nearest_warp_plain(torch.cat(arrays, -1),
                                                  augment.rotation_locations(th, 40, 36)),
                      [1, 4, 2, 1, 4, 3], -1)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_rotate_batch_launches_kernel(cuda):
    x = torch.rand(3, 32, 32, 4, device=cuda)
    before = cuda_kernels.NEAREST_WARP.launches
    out = augment.random_rotate_batch([x[..., :1], x[..., 1:]], torch.zeros(3, device=cuda))
    assert cuda_kernels.NEAREST_WARP.launches == before + 1
    assert torch.equal(torch.cat(out, -1), x)


def test_new_wrappers_reject_bad_inputs(cuda):
    vol, locs, g = _bwd_inputs(cuda)
    bad_bwd = [
        (vol.half(), locs, g.half()),                  # dtype
        (vol, locs[:, :-1], g),                        # locs shape
        (vol, locs.double(), g),                       # locs dtype
        (vol, locs, g[..., :4]),                       # g shape
        (vol, locs, g.transpose(1, 2)),                # g shape (H != W)
        (vol, locs, g.double()),                       # g dtype
        (vol, locs, g.cpu()),                          # g device
        (vol.cpu(), locs, g),                          # device
    ]
    for args in bad_bwd:
        with pytest.raises(ValueError):
            cuda_kernels.tps_warp_bwd(*args)
    for args in ((vol.half(), locs), (vol, locs[:, :-1]), (vol.cpu(), locs)):
        with pytest.raises(ValueError):
            cuda_kernels.nearest_warp(*args)
    cos_t = torch.ones(3, device=cuda)
    x = vol[..., :4].contiguous()
    bad_group = [
        ([], cos_t, cos_t),                            # no array
        ([x] * 5, cos_t, cos_t),                       # more than MAX_GROUP
        ([x, x.half()], cos_t, cos_t),                 # dtypes differ
        ([x, x[:2]], cos_t, cos_t),                    # batch differs
        ([x, vol[..., :4]], cos_t, cos_t),             # not contiguous
        ([x, x.cpu()], cos_t, cos_t),                  # device differs
        ([x], cos_t[:2], cos_t),                       # cos shape
        ([x], cos_t, cos_t.double()),                  # sin dtype
    ]
    for args in bad_group:
        with pytest.raises(ValueError):
            cuda_kernels.rotate_group(*args)


# ------------------------------------------------------ round half even (B4)

def _ties(n, seed, dtype, device):
    """n values with exact .5 ties (every fourth value), integers and
    random values in [-4, 4)."""
    r = np.random.RandomState(seed)
    x = (r.rand(n) * 8 - 4).astype(np.float32)
    x[::4] = np.floor(x[::4]) + 0.5
    x[1::8] = np.round(x[1::8])
    x[:6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 1000, 128 * 257 + 3, 12 * 8 * 192 * 192])
def test_round_ste_kernel_bit_exact(cuda, dtype, n):
    """Against torch.round (half to even), value for value, at sizes that
    are and are not multiples of 128, of a 16-byte word and of the block,
    and from an unaligned start (a view one element in)."""
    x = _ties(max(n + 1, 6), n, dtype, cuda)
    for v in (x[:n], x[1:n + 1]):
        got = cuda_kernels.round_ste(v)
        assert got.dtype == dtype and got.shape == v.shape
        assert torch.equal(got, torch.round(v))
    assert torch.equal(cuda_kernels.round_ste(x[:6]).float().cpu(),
                       torch.tensor([0.0, 2.0, 2.0, -0.0, -2.0, -2.0]))


def test_round_ste_rejects_bad_inputs(cuda):
    x = torch.rand(4, 8, 6, 6, device=cuda)
    for bad in (x.transpose(1, 2), x.half(), x.double(), x.cpu()):
        with pytest.raises(ValueError):
            cuda_kernels.round_ste(bad)


def test_round_ste_identity_gradient_on_cuda(cuda):
    from multimodal_segmentation_torch.ops.rounding import round_ste

    x = (torch.rand(2, 8, 16, 16, device=cuda) * 2).requires_grad_(True)
    before = cuda_kernels.ROUND_STE.launches
    y = round_ste(x.transpose(2, 3))   # non-contiguous: made contiguous first
    (y * 3.0).sum().backward()
    assert cuda_kernels.ROUND_STE.launches == before + 1
    assert torch.equal(y, torch.round(x.transpose(2, 3)))
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


# ------------------------------------------------ the eval-mode conv epilogue

# (C, H, W) of every BatchNorm'd convolution of the DAFNet encoders and
# segmentor at dafnet_chaos width (the up path repeats the down path's)
EPILOGUE_SHAPES = [(64, 192, 192), (128, 96, 96), (256, 48, 48), (512, 24, 24),
                   (1024, 12, 12)]


def _randomise_conv_norms_(module, seed):
    """Conv biases and BatchNorm parameters and statistics away from their
    initial zeros and ones, so every step of the epilogue rounds."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, blocks.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.3)
            if isinstance(m, blocks.BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
                m.running_var.copy_(torch.rand(c, generator=g) * 2.0 + 1e-3)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.3)
    return module


def _epilogue_case(c, relu, seed):
    """(kernel, plain version, the module chain) on c for a seeded
    BatchNorm and conv bias."""
    C = c.shape[1]
    conv = _randomise_conv_norms_(blocks.Conv2d(1, C, 1), seed).to(c.device)
    norm = _randomise_conv_norms_(blocks.BatchNorm(C), seed + 1000).to(c.device).eval()
    args = (conv.bias, norm.running_mean, norm.running_var, norm.weight, norm.bias, norm.eps,
            relu)
    got = cuda_kernels.bn_epilogue(c, *args)
    plain = epilogue.bn_epilogue_plain(c, *args)
    chain = norm(c + conv.bias.to(c.dtype).view(1, -1, 1, 1))
    chain = F.relu(chain) if relu else chain
    torch.cuda.synchronize()
    return got, plain, chain


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_epilogue_kernel_bit_exact(cuda, dtype, relu, layout):
    """The kernel against its plain version and the module chain (cuDNN's
    bias add_, BatchNorm.forward in eval mode, F.relu), torch.equal: every
    (C, H, W) of the DAFNet encoders and segmentor at batches 26 and 100,
    then an odd H*W, a channel count that is no multiple of 8, a batch of
    one, and an unaligned buffer (the scalar path)."""
    cases = [(B, *chw) for chw in EPILOGUE_SHAPES for B in (26, 100)]
    cases += [(7, 24, 13, 11), (3, 5, 9, 9), (1, 3, 4, 4)]
    with torch.no_grad():
        for i, (B, C, H, W) in enumerate(cases + [(5, 16, 6, 6)]):
            n = B * C * H * W
            flat = (torch.randn(n + 1, device=cuda) * 3.0).to(dtype)
            unaligned = i == len(cases)
            base = flat[1:] if unaligned else flat[:n]
            if layout == "nchw":
                c = base.view(B, C, H, W)
            else:
                c = base.view(B, H, W, C).permute(0, 3, 1, 2)
                assert c.is_contiguous(memory_format=torch.channels_last)
            got, plain, chain = _epilogue_case(c, relu, seed=i)
            assert got.dtype == dtype and got.stride() == c.stride()
            assert torch.equal(plain, chain), (B, C, H, W)
            assert torch.equal(got, chain), (B, C, H, W, unaligned,
                                             (got.float() - chain.float()).abs().max().item())


def test_bn_epilogue_rejects_bad_inputs(cuda):
    norm = blocks.BatchNorm(4).to(cuda)
    args = (torch.zeros(4, device=cuda), norm.running_mean, norm.running_var, norm.weight,
            norm.bias, norm.eps, True)
    c = torch.zeros(2, 4, 3, 3, device=cuda)
    for bad, match in ((c.half(), "float32 or bfloat16"), (c[:, :, :2], "contiguous NCHW"),
                       (c[0], r"\(N, C, H, W\)")):
        with pytest.raises(ValueError, match=match):
            cuda_kernels.bn_epilogue(bad, *args)
    with pytest.raises(ValueError, match="mean must be"):
        cuda_kernels.bn_epilogue(c, args[0], norm.running_mean[:3], *args[2:])


def _seeded_bf16_dafnet(seed=0):
    conf = dafnet_chaos()
    conf.compute_dtype = "bfloat16"
    model = _randomise_conv_norms_(build_model(conf, device="cuda"), seed)
    with torch.no_grad():
        model.enc_anatomy.conv_anatomy.weight.mul_(5.0)
        model.fuser.locnet.Dense_1.weight.normal_(
            0.0, 1e-2, generator=torch.Generator("cuda").manual_seed(seed))
    return model


def test_predict_mask_through_the_epilogue_equals_the_plain_chain(cuda, monkeypatch):
    """predict_mask(1, 'max') of a seeded bf16 dafnet_chaos model on a
    26-slice study: the same tensor with the epilogue as with its plain
    version in the kernel's place, and as with the blocks' op-by-op chain
    (the convolutions' own bias; forced by taking the card out of
    conv_norm's decision); exactly 32 epilogue launches a call: 30 in the
    encoders, 2 in the segmentor."""
    model = _seeded_bf16_dafnet()
    r = np.random.RandomState(0)
    x = [r.rand(26, 192, 192, 1).astype(np.float32) for _ in range(2)]
    cuda_kernels.reset_launch_counts()
    got = model.predict_mask(1, "max", x, device="cuda")
    got2 = model.predict_mask(1, "max", x, device="cuda")
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 2 * 32
    with monkeypatch.context() as m:
        m.setattr(epilogue, "_bn_epilogue_cuda", epilogue.bn_epilogue_plain)
        plain = model.predict_mask(1, "max", x, device="cuda")
    monkeypatch.setattr(blocks, "_on_card", lambda t: False)
    ref = model.predict_mask(1, "max", x, device="cuda")
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 2 * 32
    assert torch.equal(got, got2)
    assert torch.equal(got, plain)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_mode_gradients_through_the_epilogue(cuda, monkeypatch, dtype):
    """A full-width ConvBlock and UpsampleBlock in eval mode while autograd
    records: the kernel runs (one launch a BatchNorm'd convolution) and its
    output carries a backward; output and gradients equal those with the
    plain version in the kernel's place, bit for bit (cuDNN's backward
    held to its deterministic algorithms, so that two runs can agree)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(0)
    mods = [blocks.ConvBlock(32, 64), blocks.UpsampleBlock(64, 32)]
    mods = [_randomise_conv_norms_(m, seed).to(cuda).eval() for seed, m in enumerate(mods)]
    x = torch.randn(4, 32, 48, 48, device=cuda, dtype=dtype)
    params = [p for m in mods for p in m.parameters()]

    def run():
        xr = x.clone().requires_grad_(True)
        y = mods[1](mods[0](xr))
        g = torch.ones_like(y)
        return [y, *torch.autograd.grad(y, [xr, *params], g)]

    cuda_kernels.reset_launch_counts()
    got = run()
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 3
    monkeypatch.setattr(epilogue, "_bn_epilogue_cuda", epilogue.bn_epilogue_plain)
    ref = run()
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 3
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), i


def test_epilogue_is_not_launched_in_train_mode(cuda):
    """The dual encoder and the segmentor at full width: a train-mode
    forward and backward launch no epilogue; the eval-mode forward under
    no_grad launches 32."""
    model = _seeded_bf16_dafnet()
    x = torch.rand(2, 1, 192, 192, device=cuda)
    cuda_kernels.reset_launch_counts()
    model.train()
    s1, s2 = model.enc_anatomy(x, x)
    model.segmentor(torch.cat([s1, s2])).float().sum().backward()
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 0
    model.eval()
    with torch.no_grad():
        s1, _ = model.enc_anatomy(x, x)
        model.segmentor(s1)
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 32


@pytest.mark.parametrize("layout", ["ncdhw", "channels_last_3d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_epilogue_on_volumes_bit_exact(cuda, dtype, layout):
    """A 5-D (N, C, D, H, W) conv output through the epilogue as its (N, C,
    D, H*W) view: the plain version and the module chain (the bias add,
    BatchNorm3d in eval mode, F.relu) bit for bit, in the input's layout;
    the 3D U-Net's level-0 and bottom shapes at batch 2, and odd sizes."""
    from multimodal_segmentation_torch.nn.unet3d import BatchNorm3d

    cases = [(2, 64, 112, 128, 128), (2, 512, 7, 9, 9), (3, 5, 7, 9, 11)]
    with torch.no_grad():
        for i, (N, C, D, H, W) in enumerate(cases):
            c = (torch.randn(N, C, D, H, W, device=cuda) * 3.0).to(dtype)
            if layout == "channels_last_3d":
                c = c.contiguous(memory_format=torch.channels_last_3d)
            conv = _randomise_conv_norms_(blocks.Conv2d(1, C, 1), i).to(cuda)
            norm = _randomise_conv_norms_(BatchNorm3d(C), i + 1000).to(cuda).eval()
            args = (conv.bias, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                    norm.eps, True)
            got = epilogue.bn_epilogue(c, *args)
            plain = epilogue.bn_epilogue_plain(c.view(N, C, D, H * W), *args).view(c.shape)
            chain = F.relu(norm(c + conv.bias.to(dtype).view(1, -1, 1, 1, 1)))
            torch.cuda.synchronize()
            assert got.shape == c.shape and got.stride() == c.stride()
            assert torch.equal(plain, chain), (N, C, D, H, W)
            assert torch.equal(got, chain), (N, C, D, H, W)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet3d_cicek_predict_on_the_card(cuda, monkeypatch, dtype):
    """The 3D U-Net at base width 4 (92^3 input tiles, 4^3 output tiles) by
    overlap-tile on a (6, 7, 4) volume, 2 tiles a forward: 14 epilogue
    launches a forward; the same probabilities bit for bit with the plain
    version in the kernel's place and with the op-by-op chain (the card
    taken out of conv_norm's decision); within 1e-4 of the CPU's in
    float32 (cuDNN and the CPU sum in other orders)."""
    import types

    from benchmark.reference.unet3d import MODEL
    from benchmark.traffic import volumes
    from multimodal_segmentation_torch.config import unet3d_cicek
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter

    conf = dataclasses.replace(unet3d_cicek(), volume_shape=(92, 92, 92, 3), filters3d=4,
                               batch_size=2, compute_dtype=dtype)
    state = volumes.make_weights(MODEL, types.SimpleNamespace(**dataclasses.asdict(conf)),
                                 {"depths": [6, 6], "hw": [7, 7], "blobs": 4}, 3, cuda)
    v = volumes.render((6, 7, 4), 3, 4, torch.Generator().manual_seed(4), "cpu").numpy()[None]
    seg = Cardiac3DSegmenter(conf, device=cuda)
    net, _ = seg.init(state_dict=state)
    cuda_kernels.reset_launch_counts()
    got = seg.predict(net, v)
    assert cuda_kernels.launch_counts()["bn_epilogue"] == 2 * 14
    with monkeypatch.context() as m:
        m.setattr(epilogue, "_bn_epilogue_cuda", epilogue.bn_epilogue_plain)
        plain = seg.predict(net, v)
    monkeypatch.setattr(blocks, "_on_card", lambda t: False)
    chain = seg.predict(net, v)
    assert got.shape == (1, 6, 7, 4, 3) and got.is_cuda
    assert torch.equal(got, plain)
    assert torch.equal(got, chain)
    if dtype == "float32":
        cpu = Cardiac3DSegmenter(conf, device="cpu")
        ref = cpu.predict(cpu.init(state_dict={k: t.cpu() for k, t in state.items()})[0], v)
        assert (got.cpu() - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("N, C, K, D, H, W, aligned", [
    (2, 3, 32, 12, 13, 14, True), (1, 1, 4, 3, 3, 4, True), (3, 4, 40, 9, 10, 12, True),
    (2, 2, 3, 6, 20, 8, True), (2, 3, 4, 92, 92, 92, True), (1, 2, 64, 5, 34, 34, True),
    (2, 4, 8, 5, 9, 10, True), (1, 1, 70, 4, 7, 8, True), (2, 3, 32, 12, 13, 14, False),
    (2, 3, 96, 7, 9, 10, True),
])
def test_thin_conv3d_kernel_matches_plain(cuda, N, C, K, D, H, W, aligned):
    """The thin-input convolution kernel against its plain version (an
    exact sum rounded once) and against cuDNN's F.conv3d, in bf16 on 1-4
    input channels (each instantiation), 3-96 output channels (one and
    three blocks of 32; K = 32, K > 32, and K not a multiple of 8, whose
    voxels' runs the kernel writes element by element), tiles that do and
    do not end a sample, an input that is not 4-byte aligned (the wrapper
    copies it) and the base-width-4 U-Net's tile: every output within one
    rounding of either (the kernel sums in f32), in channels_last_3d with
    the plain version's strides; one launch a call."""
    dtype = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(C * 100 + K)
    x = torch.randn(N, C, D, H, W, device=cuda, generator=g).to(dtype)
    if not aligned:
        x = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)[1:].view(x.shape).copy_(x)
        assert x.data_ptr() % 4
    w = (torch.randn(K, C, 3, 3, 3, device=cuda, generator=g) * 0.2).to(dtype)
    cuda_kernels.reset_launch_counts()
    got = thin_conv.thin_conv3d(x, w)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["thin_conv3d"] == 1
    assert got.shape == (N, K, D - 2, H - 2, W - 2) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last_3d) and torch.isfinite(got).all()
    plain = thin_conv.thin_conv3d_plain(x, w)
    assert got.stride() == plain.stride()
    eps = torch.finfo(dtype).eps
    for ref in (plain, F.conv3d(x, w)):
        gap = (got.float() - ref.float()).abs()
        assert (gap <= eps * ref.float().abs() + 1e-3).all(), gap.max().item()


def test_thin_conv3d_refuses_what_it_is_not_built_for(cuda):
    """The operator raises ValueError for what no instantiation serves:
    fp16, 5 input channels, an odd width, an input not 4-byte aligned; and
    the U-Net's decision sends each of those to cuDNN."""
    from multimodal_segmentation_torch.nn import unet3d

    def case(dtype=torch.bfloat16, C=3, W=10, offset=0):
        x = torch.zeros(2 * C * 5 * 6 * W + offset, device=cuda, dtype=dtype)
        return x[offset:].view(2, C, 5, 6, W), thin_conv.pack_weight(
            torch.zeros(8, C, 3, 3, 3, device=cuda, dtype=dtype))

    x, wp = case()
    assert cuda_kernels.thin_conv3d(x, wp, 8).shape == (2, 8, 3, 4, 8)
    assert unet3d._thin_input(x, x.dtype)
    for kw in ({"dtype": torch.float16}, {"C": 5}, {"W": 11}, {"offset": 1}):
        x, wp = case(**kw)
        with pytest.raises(ValueError, match="thin_conv3d"):
            cuda_kernels.thin_conv3d(x, wp, 8)
        if "offset" not in kw:
            assert not unet3d._thin_input(x, x.dtype)


def test_thin_conv3d_gradients_on_the_card(cuda):
    """While autograd records, the kernel's output carries the
    convolution's backward: the bf16 input and weight gradients through
    the thin-input path equal those through F.conv3d (the same cuDNN
    backward of the same incoming gradient, so within one bf16 rounding
    of each other), at the first level of the base-width-4 U-Net."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x0 = torch.randn(2, 3, 20, 22, 24, device=cuda, generator=g).bfloat16()
    w0 = (torch.randn(4, 3, 3, 3, 3, device=cuda, generator=g) * 0.2).bfloat16()
    gy = torch.randn(2, 4, 18, 20, 22, device=cuda, generator=g).bfloat16()
    got, ref = [], []
    for conv, out in ((thin_conv.thin_conv3d, got), (F.conv3d, ref)):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        conv(x, w).backward(gy)
        out += [x.grad, w.grad]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        gap = (a.float() - b.float()).abs()
        assert (gap <= 2 * torch.finfo(torch.bfloat16).eps * b.float().abs() + 1e-2).all(), \
            gap.max().item()



@pytest.mark.parametrize("N, C, D, H, W", [
    (1, 48, 128, 128, 128), (1, 96, 128, 128, 128), (1, 48, 64, 64, 64), (1, 96, 64, 64, 64),
    (1, 48, 5, 7, 9), (2, 96, 3, 4, 70), (1, 48, 9, 13, 130), (2, 48, 7, 6, 65),
    (1, 96, 1, 1, 1),
])
def test_same_conv3d_kernel_matches_cudnn(cuda, N, C, D, H, W):
    """The 48-output-channel same convolution's kernel against cuDNN's
    F.conv3d(padding=1) in bf16 on the same channels_last_3d input, at the
    four shapes of Swin UNETR's seven convolutions a window and at odd
    extents (W, H and D that no tile divides, 1-voxel axes, two samples).
    Both sum the bf16 products in f32 on the tensor cores, in other
    orders, and round once to bf16: each output is within one bf16
    rounding of the other's, |gap| <= eps |ref| (eps the bf16 spacing at
    1), with 1e-3 besides for outputs near 0 and at a power of two, where
    one rounding step below is half of one above. Against the plain
    version (the exact sum rounded once) the same, at the shapes it
    computes in a few seconds. channels_last_3d out; bit for bit the same
    on a second call; one launch a call."""
    dtype = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(C + D + H + W)
    x = torch.randn(N, C, D, H, W, device=cuda, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    w = (torch.randn(48, C, 3, 3, 3, device=cuda, generator=g) / (27 * C) ** 0.5).to(dtype)
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        got = same_conv.same_conv3d(x, w)
        again = same_conv.same_conv3d(x, w)
        torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["same_conv3d"] == 2
    assert got.shape == (N, 48, D, H, W) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last_3d) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    refs = [F.conv3d(x, w.contiguous(memory_format=torch.channels_last_3d), padding=1)]
    if x.numel() < 2 ** 22:
        refs.append(same_conv.same_conv3d_plain(x, same_conv.pack_weight(w)))
    eps = torch.finfo(dtype).eps
    for ref in refs:
        gap = (got.float() - ref.float()).abs()
        assert (gap <= eps * ref.float().abs() + 1e-3).all(), gap.max().item()


def test_same_conv3d_refuses_what_it_is_not_built_for(cuda):
    """The operator raises ValueError for what it is not built for: fp16,
    64 input channels, an input that is not channels_last_3d, one not
    16-byte aligned, weights not packed for its channels. The wrapper
    copies an NCDHW or misaligned input to channels_last_3d first, so
    through it those two run."""
    def case(C=48, dtype=torch.bfloat16):
        x = torch.zeros(1, C, 3, 4, 5, device=cuda, dtype=dtype)
        return x.contiguous(memory_format=torch.channels_last_3d), same_conv.pack_weight(
            torch.zeros(48, C, 3, 3, 3, device=cuda, dtype=dtype))

    x, wp = case()
    assert cuda_kernels.same_conv3d(x, wp).shape == (1, 48, 3, 4, 5)
    bad = [case(dtype=torch.float16), case(C=64), (x.contiguous(), wp), (x, case(C=96)[1])]
    shifted = torch.zeros(x.numel() + 1, device=cuda, dtype=x.dtype)[1:]
    bad.append((shifted.view(1, 3, 4, 5, 48).permute(0, 4, 1, 2, 3), wp))
    assert bad[-1][0].is_contiguous(memory_format=torch.channels_last_3d)
    for bx, bwp in bad:
        with pytest.raises(ValueError, match="same_conv3d"):
            cuda_kernels.same_conv3d(bx, bwp)
    w = torch.zeros(48, 48, 3, 3, 3, device=cuda, dtype=x.dtype)
    for xx in (x.contiguous(), bad[-1][0]):
        assert same_conv.same_conv3d(xx, w).shape == (1, 48, 3, 4, 5)


_THIN_PROFILE = r"""
import json, torch
from torch.profiler import ProfilerActivity, profile
from multimodal_segmentation_torch import config
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
from multimodal_segmentation_torch.ops import cuda_kernels
torch.backends.cudnn.allow_tf32 = False
net, _ = Cardiac3DSegmenter(config.unet3d_cicek(), device="cuda").init(0)
x = torch.rand(2, 3, 116, 132, 132, device="cuda").bfloat16()
with torch.inference_mode():
    net(x)
    cuda_kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net(x)
        torch.cuda.synchronize()
print(json.dumps({"count": cuda_kernels.launch_counts()["thin_conv3d"],
                  "names": [e.key for e in prof.key_averages() if e.device_time_total > 0]}))
"""


def test_unet3d_first_conv_takes_the_thin_kernel(cuda, monkeypatch):
    """One bf16 forward of the published-width 3D U-Net on 2 tiles of 132 x
    132 x 116. Under torch.profiler, in a process of its own: run in this
    process, that profiling session left test_program_spans_on_the_device_
    traces_clock's later one with no device activity when the whole file
    ran. Any CUDA-only profiling session at that point does so: with the
    thin-input path taken out, one F.conv3d or one bf16 matmul in its
    place (PERF.md), so the kernel is not the cause. There the
    first convolution runs as the thin-input kernel, no kernel is cuDNN's
    legacy implicit_convolveNd_sgemm, one launch, and no kernel is one of
    cuDNN's layout transforms (nchwToNhwc, nhwcToNchw): the net runs
    channels_last_3d from the kernel's output on. Here, with the benchmark
    maker's weights: one launch, none with the path taken out; the
    probabilities' mean gap from the same forward through cuDNN (the
    thin-input path taken out) no larger than that forward's own gap from
    the float32 net's."""
    import json
    import subprocess
    import sys
    import types

    from benchmark.reference.unet3d import MODEL
    from benchmark.traffic import volumes
    from multimodal_segmentation_torch.config import unet3d_cicek
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.nn import unet3d

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _THIN_PROFILE], cwd=repo, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    profiled = json.loads(run.stdout.splitlines()[-1])
    assert profiled["count"] == 1
    names = profiled["names"]
    assert not any("implicit_convolveNd_sgemm" in n for n in names), names
    assert any("thin_conv3d_kernel" in n for n in names), names
    assert not any("nchwToNhwc" in n or "nhwcToNchw" in n for n in names), names

    conf = unet3d_cicek()
    state = volumes.make_weights(MODEL, types.SimpleNamespace(**dataclasses.asdict(conf)),
                                 {"depths": [56, 56], "hw": [240, 240], "blobs": 6}, 5, cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.stack([volumes.render((116, 132, 132), 3, 6, g, cuda).permute(3, 0, 1, 2)
                     for _ in range(2)])
    net, _ = Cardiac3DSegmenter(conf, device=cuda).init(state_dict=state)
    f32 = dataclasses.replace(conf, compute_dtype="float32")
    net32, _ = Cardiac3DSegmenter(f32, device=cuda).init(state_dict=state)
    with torch.inference_mode():
        cuda_kernels.reset_launch_counts()
        got = net(x.bfloat16())
        torch.cuda.synchronize()
        assert cuda_kernels.launch_counts()["thin_conv3d"] == 1
        monkeypatch.setattr(unet3d, "_thin_input", lambda x, dt: False)
        ref = net(x.bfloat16())
        ref32 = net32(x)
        torch.cuda.synchronize()
        assert cuda_kernels.launch_counts()["thin_conv3d"] == 1
    # the published widths leave GBs in the caching allocator; give them back
    del net, net32, state, x
    torch.cuda.empty_cache()
    assert got.shape == (2, 3, 28, 44, 44)
    gap = (got - ref).abs().mean().item()
    rounding = (ref - ref32).abs().mean().item()
    print("thin vs cuDNN: mean %.3g max %.3g; cuDNN bf16 vs f32: mean %.3g"
          % (gap, (got - ref).abs().max().item(), rounding))
    assert gap <= rounding


_SWIN_PROFILE = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from benchmark.harness.program_spans import attribute
from benchmark.harness.trace import Trace, kernel_kind
from multimodal_segmentation_torch import config
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
from multimodal_segmentation_torch.ops import cuda_kernels
from multimodal_segmentation_torch.utils import tracing
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
seg = Cardiac3DSegmenter(config.swin_unetr_brats(), device="cuda")
net, _ = seg.init(0)
v = torch.rand(1, 128, 128, 160, 4).numpy()
seg.predict(net, v)
torch.cuda.synchronize()
cuda_kernels.reset_launch_counts()
tracing.clear()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    seg.predict(net, v)
    torch.cuda.synchronize()
a = attribute(Trace(prof, 1.0), tracing.spans())
kinds = {}
for owner in ("predict3d.attention", "predict3d.resblock"):
    kinds[owner] = sorted({kernel_kind(n) for n in a.ops[owner]})
print(json.dumps({"launches": cuda_kernels.launch_counts(),
                  "device_s": dict(a.device_s), "kinds": kinds,
                  "names": sorted({n for ops in a.ops.values() for n in ops})}))
"""


def test_swin_unetr_spans_on_the_card(cuda):
    """One published-width bf16 predict of a (128, 128, 160) study (1 x 1 x 2
    windows, one forward), profiled CUDA-only in a process of its own (a
    second profiling session in the file's process can record nothing,
    PERF.md): device time lands in `predict3d.attention` and
    `predict3d.resblock` as well as in `predict3d.net`; the first
    convolution runs as the thin-input kernel, once a window, and the seven
    48-output-channel ones as the same-convolution kernel, which the
    benchmark files under convolution; nothing that it files so runs
    inside an attention span; no kernel is one of cuDNN's layout
    transforms, nor the sm80 256 x 32 fprop kernel that cuDNN ran those
    seven in."""
    import json
    import subprocess
    import sys

    from benchmark.harness.trace import kernel_kind

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _SWIN_PROFILE], cwd=repo, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.splitlines()[-1])
    print(json.dumps(got))
    for owner in ("predict3d.attention", "predict3d.resblock", "predict3d.net"):
        assert got["device_s"].get(owner, 0) > 0, got["device_s"]
    assert got["launches"]["thin_conv3d"] == 2
    assert got["launches"]["same_conv3d"] == 14
    same = [n for n in got["names"] if "same_conv3d_c48_kernel" in n]
    assert same and all(kernel_kind(n) == "convolution" for n in same), got["names"]
    assert "convolution" not in got["kinds"]["predict3d.attention"], got["kinds"]
    assert not any("nchwToNhwc" in n or "nhwcToNchw" in n for n in got["names"]), got["names"]
    assert not any("sm80_xmma_fprop" in n and "256x32x32" in n for n in got["names"]), \
        got["names"]


def test_swin_unetr_published_forward_on_the_card(cuda, monkeypatch):
    """A published-width bf16 forward of 4 windows of 128^3 x 4 (the
    benchmark maker's weights, rendered studies): 4 thin-input launches
    (enc0's first convolution, one a window) and 28 of the same
    convolution (seven a window), each of whose inputs is channels_last_3d
    already, so that none is copied; the sigmoid probabilities' mean gap
    from the float32 reference's between a quarter and twice the gap of
    the reference rounding at bf16, and under half of the reference's at
    fp8."""
    import types

    from benchmark.reference.precision import set_precision
    from benchmark.reference.swin_unetr import MODEL
    from benchmark.traffic import swin_weights, volumes
    from multimodal_segmentation_torch.config import swin_unetr_brats
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.nn import unet3d

    layouts = []

    def recorded(x, weight, wp=None):
        layouts.append(x.is_contiguous(memory_format=torch.channels_last_3d))
        return same_conv.same_conv3d(x, weight, wp)

    monkeypatch.setattr(unet3d, "same_conv3d", recorded)
    conf = swin_unetr_brats()
    ns = types.SimpleNamespace(**dataclasses.asdict(conf))
    state = swin_weights.make_weights(MODEL, ns, {"depths": [155, 155], "hw": [240, 240],
                                                  "blobs": 6}, 11, cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.stack([volumes.render((128, 128, 128), 4, 6, g, cuda).permute(3, 0, 1, 2)
                     for _ in range(4)]).contiguous()
    net, _ = Cardiac3DSegmenter(conf, device=cuda).init(state_dict=state)
    with torch.inference_mode():
        cuda_kernels.reset_launch_counts()
        got = torch.sigmoid(net(x.bfloat16()))
        torch.cuda.synchronize()
        launches = cuda_kernels.launch_counts()
    assert launches["thin_conv3d"] == 4, launches
    assert launches["same_conv3d"] == 28 and layouts == [True] * 28, (launches, layouts)
    del net
    refs = {}
    for precision in ("float32", "bfloat16", "fp8"):
        model = MODEL(ns)
        model.load_state_dict(state)
        model = set_precision(model.to(cuda), precision).eval()
        with torch.no_grad():
            refs[precision] = torch.sigmoid(model(x))
        del model
        torch.cuda.empty_cache()
    gap = (got - refs["float32"]).abs().mean().item()
    rounding = (refs["bfloat16"] - refs["float32"]).abs().mean().item()
    fp8 = (refs["fp8"] - refs["float32"]).abs().mean().item()
    print("swin: program %.3g, bf16 reference %.3g, fp8 reference %.3g; program's max %.3g"
          % (gap, rounding, fp8, (got - refs["float32"]).abs().max().item()))
    del refs, got, x, state
    torch.cuda.empty_cache()
    assert 0.25 * rounding <= gap <= 2.0 * rounding
    assert gap < 0.5 * fp8


def test_swin_unetr_tiny_predict_on_the_card_matches_cpu(cuda):
    """Feature size 12, 64^3 windows, a (64, 67, 70) study in float32: the
    card's predict within 1e-4 of the CPU's (cuDNN, cuBLAS and the
    memory-efficient attention sum in other orders)."""
    import types

    from benchmark.reference.swin_unetr import MODEL
    from benchmark.traffic import swin_weights, volumes
    from multimodal_segmentation_torch.config import swin_unetr_brats
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter

    conf = dataclasses.replace(swin_unetr_brats(), volume_shape=(64, 64, 64, 4), filters3d=12,
                               batch_size=2, compute_dtype="float32")
    state = swin_weights.make_weights(MODEL, types.SimpleNamespace(**dataclasses.asdict(conf)),
                                      {"depths": [64, 64], "hw": [66, 66], "blobs": 4}, 3, "cpu")
    v = volumes.render((64, 67, 70), 4, 4, torch.Generator().manual_seed(4), "cpu").numpy()[None]
    seg = Cardiac3DSegmenter(conf, device=cuda)
    got = seg.predict(seg.init(state_dict={k: t.to(cuda) for k, t in state.items()})[0], v)
    cpu = Cardiac3DSegmenter(conf, device="cpu")
    ref = cpu.predict(cpu.init(state_dict=state)[0], v)
    assert got.shape == (1, 64, 67, 70, 3) and got.is_cuda
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


# ----------------------------------------------------------- training step

def _expert_batch(conf, seed=0):
    r = np.random.RandomState(seed)
    B, hw, nm = conf.batch_size, conf.input_hw, conf.num_masks

    def masks():
        lab = r.randint(0, nm + 1, size=(B,) + hw)
        return (lab[..., None] == np.arange(nm)).astype(np.float32)

    img = lambda: (r.rand(B, *hw, 1) * 2 - 1).astype(np.float32)  # noqa: E731
    return {"x1": img(), "x2": img(), "m1": masks(), "m2": masks(),
            "dm1": masks(), "dm2": masks(), "dx1": img(), "dx2": img()}


def test_full_width_train_step_runs_through_the_kernels(cuda):
    """One dafnet_chaos step_supervised at batch 6, 192x192: finite
    metrics, and the kernels launched 2 (warp), 1 (warp backward), 3
    (rotations) and 2 (rounding: the loss and the fake pools) times; the
    conv epilogue 32 times, all in the fake pools' eval-mode forward (30
    in the dual encoder, 2 in the segmentor): the train-mode loss takes
    none."""
    conf = dafnet_chaos()
    model = build_model(conf, device="cuda")
    with torch.no_grad():
        model.fuser.locnet.Dense_1.weight.normal_(0.0, 1e-2)
    ts = create_train_state(model, conf)
    steps = DAFNetSteps(model, conf)
    bal = [p.clone() for p in model.balancer.parameters()]
    cuda_kernels.reset_launch_counts()
    ts, metrics = steps.step_supervised(ts, _expert_batch(conf))
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts() == {"tps_warp_fwd": 2, "tps_warp_bwd": 1,
                                            "nearest_warp": 3, "round_ste": 2,
                                            "tps_flow_dbg": 0, "bn_epilogue": 32, "thin_conv3d": 0,
                                            "same_conv3d": 0}
    assert all(torch.isfinite(v).item() for v in metrics.values()), metrics
    assert all(torch.equal(a, b) for a, b in zip(model.balancer.parameters(), bal))


def test_full_width_bf16_train_step_runs_through_the_kernels(cuda, monkeypatch):
    """The same step at compute_dtype bfloat16: launches 2/1/3/2, finite
    f32 metrics; parameters, BatchNorm statistics and Adam moments stay f32
    and finite, and the warps ran on bf16 anatomies."""
    conf = dafnet_chaos()
    conf.compute_dtype = "bfloat16"
    model = build_model(conf, device="cuda")
    with torch.no_grad():
        model.fuser.locnet.Dense_1.weight.normal_(0.0, 1e-2)
    ts = create_train_state(model, conf)
    steps = DAFNetSteps(model, conf)
    dtypes = []
    warp = tps.tps_warp_fwd
    monkeypatch.setattr(tps, "tps_warp_fwd", lambda vol, *a: dtypes.append(vol.dtype) or warp(vol, *a))
    cuda_kernels.reset_launch_counts()
    ts, metrics = steps.step_supervised(ts, _expert_batch(conf))
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts() == {"tps_warp_fwd": 2, "tps_warp_bwd": 1,
                                            "nearest_warp": 3, "round_ste": 2,
                                            "tps_flow_dbg": 0, "bn_epilogue": 32, "thin_conv3d": 0,
                                            "same_conv3d": 0}
    assert dtypes == [torch.bfloat16, torch.bfloat16]
    assert all(v.dtype == torch.float32 and torch.isfinite(v).item() for v in metrics.values())
    state = [*model.parameters(), *model.buffers()]
    for opt in (ts.opt_gen, *ts.opt_disc.values()):
        state += [t for st in opt.state.values() for t in st.values() if t.dim() > 0]
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all().item() for t in state)


def test_tiny_executor_epoch_on_the_card(cuda, tmp_path):
    """One tiny executor epoch (3 steps, validation, image callback,
    checkpoint) on the card: every kernel of the path launches, B4 among
    them (the flow-stage dump B5 is on no training path, the 3D U-Net's
    thin-input convolution and Swin UNETR's same convolution on no 2-D
    path), and
    after the first step, which copies ops/tps.py's constants to the card
    once, no CPU tensor of more than one element enters any operation of a
    step (0-d ones are Python scalars and Adam's step counts)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from multimodal_segmentation_torch.train.executor import make_executor

    conf = tiny_test_config()
    conf.dataset_name = conf.test_dataset = "synthetic"
    conf.folder, conf.epochs, conf.steps_per_epoch = str(tmp_path), 1, 3
    ex = make_executor(conf, build_model(conf, device="cuda"))
    on_cpu = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, torch.Tensor) and a.device.type == "cpu" and a.dim() > 0
                   for a in tree_leaves((args, kwargs))):
                on_cpu.append(str(func))
            return func(*args, **kwargs)

    step = ex.steps._step
    steps_run = []

    def watched(*args):
        steps_run.append(1)
        if len(steps_run) == 1:
            return step(*args)
        with Watch():
            return step(*args)

    ex.steps._step = watched
    cuda_kernels.reset_launch_counts()
    ts = ex.train()
    torch.cuda.synchronize()
    launches = cuda_kernels.launch_counts()
    assert ts.step == 3 and ts.epoch == 0
    assert launches.pop("tps_flow_dbg") == 0
    assert launches.pop("thin_conv3d") == 0
    assert launches.pop("same_conv3d") == 0
    assert all(n > 0 for n in launches.values()), launches
    assert launches["round_ste"] >= 2 * 3 + 6   # 3 steps, 6 validation predictions
    assert on_cpu == []


def test_spade_decoder_on_the_card_matches_cpu(cuda):
    """The SPADE decoder at full dafnet_spade_chaos width (128 channels,
    192x192, two anatomies), f32 with TF32 off, from the same seeded
    weights on the card and on the CPU: the images within 1e-4 of each
    other; the gradients of a loss on the image with respect to z and to
    every parameter on the card, each within 1e-2 of its largest entry of
    the float64 gradient on the CPU, or of 1e-4 of the largest gradient
    where that is larger (the deepest cross six blocks of instance norms
    and 128-channel convolutions). The CPU's own f32 error is printed: it
    was 2.0e-3 on one CPU and 1.4e-2 on the H100 machine's."""
    from multimodal_segmentation_torch.config import dafnet_spade_chaos
    from multimodal_segmentation_torch.nn import Decoder
    from multimodal_segmentation_torch.nn.blocks import flax_init_

    conf = dafnet_spade_chaos()
    r = np.random.RandomState(2)
    s = (r.randint(0, 9, size=(2,) + conf.input_hw)[:, None] == np.arange(8)[:, None, None])
    s = torch.from_numpy(s.astype(np.float32))
    z = torch.from_numpy(r.randn(2, conf.num_z).astype(np.float32))
    target = torch.from_numpy(r.rand(2, 1, *conf.input_hw).astype(np.float32) * 2 - 1)
    cpu = Decoder("spade", 8, conf.num_z, torch.float32, conf.input_hw)
    flax_init_(cpu, torch.Generator().manual_seed(conf.seed))
    card = Decoder("spade", 8, conf.num_z, torch.float32, conf.input_hw).to(cuda)
    card.load_state_dict(cpu.state_dict())
    exact = Decoder("spade", 8, conf.num_z, torch.float64, conf.input_hw).double()
    exact.load_state_dict(cpu.state_dict())
    out = {}
    for name, dec, dev, dt in (("cpu", cpu, "cpu", torch.float32),
                               ("cuda", card, cuda, torch.float32),
                               ("float64", exact, "cpu", torch.float64)):
        zz = z.to(dev, dt).requires_grad_(True)
        y = dec(s.to(dev, dt), zz)
        loss = (y - target.to(dev, dt)).square().mean()
        grads = torch.autograd.grad(loss, [zz, *dec.parameters()])
        out[name] = (y.detach().cpu().double(), [g.cpu().double() for g in grads])
    assert out["cuda"][0].shape == (2, 1, *conf.input_hw)
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-4
    names = ["z"] + [n for n, _ in cpu.named_parameters()]
    # the biases of the convolutions ahead of an instance norm have a
    # gradient of exactly 0: theirs is held against 1e-4 of the largest
    scale = 1e-4 * max(g.abs().max().item() for g in out["float64"][1])
    err = {name: {n: (g - ref).abs().max().item() / max(ref.abs().max().item(), scale)
                  for n, g, ref in zip(names, out[name][1], out["float64"][1], strict=True)}
           for name in ("cuda", "cpu")}
    print("largest gradient error against float64: card %.3g (%s), CPU f32 %.3g (%s)" % (
        max(err["cuda"].values()), max(err["cuda"], key=err["cuda"].get),
        max(err["cpu"].values()), max(err["cpu"], key=err["cpu"].get)))
    assert all(torch.isfinite(g).all() for g in out["cuda"][1])
    assert max(err["cuda"].values()) <= 1e-2


def test_eval_dtype_bf16_predict_mask_on_the_card_matches_cpu(cuda):
    """eval_dtype='bfloat16' at full dafnet_chaos width: the tester's bf16
    model on the card and on the CPU, from the same seeded weights (a
    sharper anatomy head and a non-zero last LocNet Dense, as
    chip_smoke.py seeds them), on two slices of a synthetic test volume,
    each fusion type; one round_ste launch a call, and one warp for 'def'
    and 'max'. The share of pixels with another argmax on the card than on
    the CPU is at most 1e-3, or at most the share with another argmax in
    bf16 than in f32 on the card where that is larger: bf16 keeps 8 bits,
    so the two devices' convolution sums, in other orders, round some
    activations an ulp apart, and an anatomy value near 0.5 then rounds
    the other way. (f32 holds 1e-3: chip_smoke.py's cross-device phase.)"""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.eval import ModelTester

    conf = dafnet_chaos()
    model = build_model(conf, device="cuda")
    g = torch.Generator().manual_seed(conf.seed)
    with torch.no_grad():
        model.enc_anatomy.conv_anatomy.weight.mul_(5.0)
        d1 = model.fuser.locnet.Dense_1
        d1.weight.copy_(torch.randn(d1.weight.shape, generator=g) * 1e-2)
        d1.bias.copy_(torch.randn(d1.bias.shape, generator=g) * 1e-2)
    cpu_model = build_model(conf, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    conf.eval_dtype = "bfloat16"
    card = ModelTester(model, conf, device="cuda").model
    cpu = ModelTester(cpu_model, conf, device="cpu").model
    assert card.enc_anatomy.dtype == cpu.enc_anatomy.dtype == torch.bfloat16
    data = init_loader("synthetic").load_all_modalities_concatenated(0, "test")
    x = [data.get_volume_images_modi(i, data.volumes()[0])[:2] for i in (0, 1)]
    shares = {}
    for fusion in ("simple", "def", "max"):
        cuda_kernels.reset_launch_counts()
        got = card.predict_mask(1, fusion, x, device="cuda").cpu()
        launches = cuda_kernels.launch_counts()
        assert launches["round_ste"] == 1
        assert launches["tps_warp_fwd"] == (fusion != "simple")
        ref = cpu.predict_mask(1, fusion, x, device="cpu")
        f32 = model.predict_mask(1, fusion, x, device="cuda").cpu()
        assert got.dtype == ref.dtype == torch.float32
        shares[fusion] = [(got.argmax(-1) != b.argmax(-1)).float().mean().item()
                          for b in (ref, f32)]
    print("argmax differs, card vs CPU and bf16 vs f32 on the card: %s" % shares)
    for fusion, (device_share, dtype_share) in shares.items():
        assert device_share <= max(1e-3, dtype_share), (fusion, device_share, dtype_share)


# ------------------------------------------- automated pairing and MMSDNet

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernels_at_the_automated_shape(cuda, dtype):
    """B1 and B2 at B = 36, automated pairing's 2K = 6 fusion directions of
    batch 6: the forward within 2e-4 (f32) or 2e-2 (bf16) of its plain
    version; the backward at the training shape's f32 bounds, or 3e-2 of
    the largest entry in bf16."""
    got, ref = _kernel_and_plain(*_inputs(cuda, B=36, H=192, W=192, C=8, dtype=dtype))
    assert got.dtype == dtype and got.shape == (36, 192, 192, 8)
    assert (got.float() - ref.float()).abs().max().item() <= (
        2e-4 if dtype == torch.float32 else 2e-2)
    vol, locs, g = _bwd_inputs(cuda, B=36, H=192, W=192, C=8, dtype=dtype)
    gv, gl = cuda_kernels.tps_warp_bwd(vol, locs, g)
    rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(gl, rl, atol=5e-5, rtol=1e-4)
        assert (gv - rv).abs().max().item() <= 1e-5 * rv.abs().max().item()
    else:
        assert (gv.float() - rv.float()).abs().max().item() <= 3e-2
        assert (gl - rl).abs().max().item() / (rl.abs().max().item() + 1e-6) <= 3e-2


def _auto_batch(conf, seed=0):
    """An automated batch: n_pairs candidate slices a modality."""
    b = _expert_batch(conf, seed)
    r = np.random.RandomState(seed + 50)
    shape = (conf.batch_size,) + tuple(conf.input_hw) + (conf.n_pairs,)
    for k in ("x1", "x2"):
        b[k + "_pairs"] = (r.rand(*shape) * 2 - 1).astype(np.float32)
        del b[k]
    return b


def _mmsdnet_batches(conf, seed=0):
    """(generator batch, discriminator batch) of MMSDNet."""
    b = _expert_batch(conf, seed)
    return ({k: b[k] for k in ("x1", "x2", "m1", "m2")},
            {"dm": b["dm1"], "dx1": b["dx1"], "dx2": b["dx2"]})


def test_full_width_automated_step_runs_through_the_kernels(cuda, monkeypatch):
    """One dafnet_chaos step_supervised under automated pairing (n_pairs 3,
    batch 6, 192x192): finite metrics, launches 2/1/3/2, the loss's warp at
    B = 36 and the fake pools' at 12, and the balancer moves."""
    conf = dafnet_chaos()
    conf.automatedpairing = True
    model = build_model(conf, device="cuda")
    with torch.no_grad():
        model.fuser.locnet.Dense_1.weight.normal_(0.0, 1e-2)
        model.enc_anatomy.conv_anatomy.weight.mul_(5.0)
    ts = create_train_state(model, conf)
    batches = []
    warp = tps.tps_warp_fwd
    monkeypatch.setattr(tps, "tps_warp_fwd",
                        lambda vol, *a: batches.append(vol.shape[0]) or warp(vol, *a))
    bal = [p.clone() for p in model.balancer.parameters()]
    cuda_kernels.reset_launch_counts()
    ts, metrics = DAFNetSteps(model, conf).step_supervised(ts, _auto_batch(conf))
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts() == {"tps_warp_fwd": 2, "tps_warp_bwd": 1,
                                            "nearest_warp": 3, "round_ste": 2,
                                            "tps_flow_dbg": 0, "bn_epilogue": 32, "thin_conv3d": 0,
                                            "same_conv3d": 0}
    assert batches == [36, 12]
    assert all(torch.isfinite(v).item() for v in metrics.values()), metrics
    assert any(not torch.equal(a, b) for a, b in zip(model.balancer.parameters(), bal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_mmsdnet_steps_run_through_the_kernels(cuda, dtype):
    """One mmsdnet_chaos step_supervised (with its Z-regressor update) and
    one step_discriminator at batch 6, 192x192: finite f32 metrics and
    launches 3/1/3/6 (B1: the loss's two fusion directions, the
    Z-regressor's two in one call, the pool's one; B4: two private heads in
    the loss, the Z-regressor and the pool). The conv epilogue runs in the
    eval-mode forwards alone: 44 in the Z-regressor's two encoders (22
    each), 46 in the pool's (and its segmentor's 2)."""
    conf = mmsdnet_chaos()
    conf.compute_dtype = dtype
    model = build_model(conf, device="cuda")
    with torch.no_grad():
        model.fuser.locnet.Dense_1.weight.normal_(0.0, 1e-2)
    ts = create_train_state(model, conf)
    steps = make_steps(model, conf)
    gen, disc = _mmsdnet_batches(conf)
    cuda_kernels.reset_launch_counts()
    ts, metrics = steps.step_supervised(ts, gen)
    ts, d_metrics = steps.step_discriminator(ts, disc)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts() == {"tps_warp_fwd": 3, "tps_warp_bwd": 1,
                                            "nearest_warp": 3, "round_ste": 6,
                                            "tps_flow_dbg": 0, "bn_epilogue": 44 + 46,
                                            "thin_conv3d": 0, "same_conv3d": 0}
    metrics.update(d_metrics)
    assert sorted(metrics) == ["KL", "adv_M", "dis_M", "loss", "rec_X", "rec_Z",
                               "supervised_Mask"]
    assert all(v.dtype == torch.float32 and torch.isfinite(v).item()
               for v in metrics.values()), metrics
    assert ts.step == 2


@pytest.mark.parametrize("path", ["automated", "mmsdnet"])
def test_tiny_new_path_step_on_the_card_matches_cpu(cuda, path):
    """One tiny step of each new path on the card and on the CPU, from the
    same weights, batch and noise (the existing cross-device bounds):
    generator metrics, computed before any update, within 1e-3 relative;
    what reads the updated generator (the discriminators' losses and
    MMSDNet's Z-regressor loss) within 2e-2, since a conv bias ahead of a
    BatchNorm has a roundoff gradient whose Adam step takes either sign.
    The anatomy heads are sharpened (x100, the cross-device phase's 5 x 20)
    against rounding ties."""
    conf = tiny_test_config("mmsdnet" if path == "mmsdnet" else "dafnet")
    conf.automatedpairing = path == "automated"
    model = build_model(conf, device="cuda")
    with torch.no_grad():
        model.fuser.locnet.Dense_1.weight.normal_(0.0, 1e-2)
        for name, m in model.named_modules():
            if name.endswith("conv_anatomy"):
                m.weight.mul_(100.0)
    cpu_model = build_model(conf, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(3)
    B, nz, rr = conf.batch_size, conf.num_z, conf.rotation_range
    out = {}
    if path == "automated":
        batch, noise = _auto_batch(conf), draw_noise(gen, B, nz, rr)
        for name, m in (("card", model), ("cpu", cpu_model)):
            out[name] = DAFNetSteps(m, conf).step_supervised(create_train_state(m, conf),
                                                             batch, noise)[1]
    else:
        (g_batch, d_batch) = _mmsdnet_batches(conf)
        g_noise, d_noise = draw_mmsdnet_noise(gen, B, nz, rr), draw_mmsdnet_disc_noise(gen, B, rr)
        for name, m in (("card", model), ("cpu", cpu_model)):
            ts, steps = create_train_state(m, conf), make_steps(m, conf)
            ts, metrics = steps.step_supervised(ts, g_batch, g_noise)
            out[name] = {**metrics, **steps.step_discriminator(ts, d_batch, d_noise)[1]}
    assert sorted(out["card"]) == sorted(out["cpu"])
    for k, v in out["cpu"].items():
        lim = 2e-2 if k.startswith("dis_") or k == "rec_Z" else 1e-3
        rel = abs(float(out["card"][k]) / float(v) - 1.0)
        assert rel <= lim, (k, rel)


# ------------------------------------------------- volumetric path (A10, B3)

def _tiny_3d(**kw):
    return dataclasses.replace(cardiac_3d(), volume_shape=(8, 32, 32, 3), filters3d=4,
                               downsample3d=2, **kw)


@pytest.mark.parametrize("shape", [(2, 4, 33, 33, 3), (2, 16, 128, 128, 3)])
def test_volume_rotation_on_the_card_is_the_cpus_and_launches_twice(cuda, shape):
    """random_rotate_volumes on the card: bit for bit the CPU's (images and
    {0,1} masks, one angle a study), through exactly 2 nearest_warp
    launches (volumes, masks) and no other kernel."""
    r = np.random.RandomState(shape[2])
    vols = torch.from_numpy((r.rand(*shape) * 2 - 1).astype(np.float32))
    msks = torch.from_numpy((r.rand(*shape) > 0.7).astype(np.float32))
    th = torch.from_numpy(np.radians(np.array([14.2, -9.7], np.float32)))
    cuda_kernels.reset_launch_counts()
    v, m = augment.random_rotate_volumes(th.to(cuda), vols.to(cuda), msks.to(cuda))
    assert cuda_kernels.launch_counts() == {k: 2 if k == "nearest_warp" else 0
                                            for k in cuda_kernels.launch_counts()}
    cv, cm = augment.random_rotate_volumes(th, vols, msks)
    assert torch.equal(v.cpu(), cv) and torch.equal(m.cpu(), cm)
    assert not torch.equal(cv, vols) and set(m.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_3d_step_on_the_card_matches_cpu(cuda, dtype):
    """One tiny Cardiac3DSegmenter step (rotation 15) on the card and on the
    CPU from the same weights, batch and angles: 2 nearest_warp launches;
    the loss and every gradient leaf within 1e-3 relative in f32 (a leaf's
    largest difference over its largest entry), 2e-2 in bf16 (cuDNN's and
    the CPU's bf16 convolutions round differently), except the biases
    ahead of an InstanceNorm3D, whose gradient is roundoff. The CPU run
    takes the card's branch at ReLU kinks (chip_smoke.step_grads_3d)."""
    from chip_smoke import step_grads_3d
    from multimodal_segmentation_torch.data import init_loader

    conf = _tiny_3d(rotation_range=15.0, compute_dtype=dtype)
    xs, ys = init_loader("cardiac", shape=(8, 32, 32)).load_volumes(0, "training")
    vb, mb = torch.from_numpy(xs[:2]), torch.from_numpy(ys[:2])
    th = augment.random_rotation_angles(torch.Generator().manual_seed(1), 2, 15.0)
    cuda_kernels.reset_launch_counts()
    card = step_grads_3d(torch, conf, cuda, vb, mb, th)
    assert cuda_kernels.launch_counts()["nearest_warp"] == 2
    cpu = step_grads_3d(torch, conf, torch.device("cpu"), vb, mb, th, card[2])
    lim = 1e-3 if dtype == "float32" else 2e-2
    assert abs(card[0] / cpu[0] - 1) <= lim
    exempt = {"ConvBlock3D_%d.Conv_%d.bias" % (b, c) for b in range(5) for c in (0, 1)}
    for n, g in cpu[1].items():
        if n not in exempt:
            d = (card[1][n] - g).abs().max() / g.abs().max()
            assert d <= lim, (n, d.item())


# ------------------------------------------------------- data parallelism

def test_each_kernel_splits_over_the_batch_on_the_card(cuda):
    """The GSPMD batch rules' promise (pallas_kernels.py:446-594 of the
    JAX package) for the kernels: B1, B2, B3 (rotate_group and
    nearest_warp) and B4 on the halves of a batch, concatenated, equal the
    whole call bit for bit; B2's grad_vol, which adds with f32 atomics,
    within 1e-6 of its largest entry."""
    r = np.random.RandomState(11)
    B, H, W = 6, 192, 192
    vol, off = _inputs(cuda, B=B, H=H, W=W, C=8, scale=0.3, seed=11)
    wv = tps.tps_coefficients(off)
    cp = tps.control_grid((5, 5), cuda)
    locs = tps.tps_sample_locations(off, (H, W))
    g = torch.from_numpy(r.randn(B, H, W, 8).astype(np.float32)).to(cuda)
    arrays = [torch.from_numpy(r.rand(B, H, W, c).astype(np.float32)).to(cuda) for c in (1, 1, 4)]
    th = torch.from_numpy(r.uniform(-0.35, 0.35, B).astype(np.float32)).to(cuda)
    x = torch.from_numpy(r.rand(B, 8, H, W).astype(np.float32)).to(cuda)
    calls = {
        "tps_warp_fwd": lambda s: [cuda_kernels.tps_warp_fwd(vol[s], wv[s], cp)],
        "tps_warp_bwd": lambda s: list(cuda_kernels.tps_warp_bwd(vol[s], locs[s].contiguous(),
                                                                 g[s])),
        "rotate_group": lambda s: cuda_kernels.rotate_group(
            [a[s].contiguous() for a in arrays], torch.cos(th[s]), torch.sin(th[s])),
        "nearest_warp": lambda s: [cuda_kernels.nearest_warp(
            vol[s].contiguous(), augment.rotation_locations(th[s], H, W))],
        "round_ste": lambda s: [cuda_kernels.round_ste(x[s].contiguous())],
    }
    for name, call in calls.items():
        whole = call(slice(None))
        halves = [call(slice(0, 3)), call(slice(3, 6))]
        torch.cuda.synchronize()
        for k, w in enumerate(whole):
            cat = torch.cat([halves[0][k], halves[1][k]])
            if name == "tps_warp_bwd" and k == 0:
                # grad_vol adds with f32 atomics, in an order that changes
                # from run to run (csrc/tps_warp_bwd.cu): a few ulp
                assert (cat - w).abs().max().item() <= 1e-6 * w.abs().max().item(), name
            else:
                assert torch.equal(cat, w), name


def test_nccl_world_size_one_step_equals_the_mesh_free_step(cuda):
    """An NCCL process group of one rank, a data = 1 mesh: two tiny expert
    steps through the mesh code against the mesh-free steps. The first
    step's generator metrics are equal bit for bit (an all-reduce of one
    rank is a copy); every parameter within two of its Adam steps; 2/1/3/2
    launches a step, and 18 conv epilogues (the fake pools' eval-mode
    forward at downsample 2: 7 * 2 + 2 in the encoder, 2 in the
    segmentor)."""
    import socket

    import torch.distributed as dist

    from multimodal_segmentation_torch.parallel import make_mesh

    conf = tiny_test_config()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port, world_size=1,
                            rank=0)
    try:
        runs = []
        for mesh in (None, make_mesh(1)):
            model = build_model(conf, device="cuda")
            with torch.no_grad():
                model.fuser.locnet.Dense_1.weight.normal_(
                    0.0, 1e-2, generator=torch.Generator("cuda").manual_seed(1))
            ts = create_train_state(model, conf)
            steps = DAFNetSteps(model, conf, mesh)
            cuda_kernels.reset_launch_counts()
            metrics = []
            for seed in (1, 2):
                ts, m = steps.step_supervised(ts, _expert_batch(conf, seed))
                metrics.append({k: v.item() for k, v in m.items()})
            runs.append((metrics, model.state_dict(), cuda_kernels.launch_counts()))
    finally:
        dist.destroy_process_group()
    (m0, sd0, l0), (m1, sd1, l1) = runs
    # the first step's forward is the mesh-free one bit for bit; the
    # updates may differ as two mesh-free runs do (B2 adds with f32
    # atomics), by Adam steps of at most ~lr at entries near 0
    assert {k: v for k, v in m1[0].items() if not k.startswith("dis_")} == \
        {k: v for k, v in m0[0].items() if not k.startswith("dis_")}
    # at most 4 Adam steps a parameter in 2 steps (d_mask takes 2 a step),
    # each under its lr, either way
    lr = max(conf.lr, conf.d_mask_params.lr, conf.d_image_params.lr)
    for k, _ in model.named_parameters():
        assert (sd1[k] - sd0[k]).abs().max().item() <= 2.001 * 4 * lr, k
    assert l0 == l1 == {"tps_warp_fwd": 4, "tps_warp_bwd": 2, "nearest_warp": 6, "round_ste": 4,
                        "tps_flow_dbg": 0, "bn_epilogue": 2 * 18, "thin_conv3d": 0,
                        "same_conv3d": 0}


# ------------------------------------------ B1's general entry, tensor parallelism

@pytest.mark.parametrize("inverse,order,dims,C,dtype", [
    (True, 2, (5, 5), 8, torch.float32), (True, 2, (5, 5), 8, torch.bfloat16),
    (False, 3, (5, 5), 8, torch.float32), (True, 3, (4, 4), 3, torch.float32),
    (False, 1, (6, 5), 8, torch.float32)])
def test_general_warp_entry_matches_plain(cuda, inverse, order, dims, C, dtype):
    """B1's general entry (per-image centres, another order, another grid;
    C = 3 takes the channel-at-a-time blend) against its plain version
    (the same coefficients and centres, the flow in float64): 2e-4 in f32,
    2e-2 in bf16; through tps_warp it is one general launch."""
    r = np.random.RandomState(order)
    B, H, W = 3, 64, 48
    vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(cuda, dtype)
    n = dims[0] * dims[1]
    off = torch.from_numpy(((r.rand(B, n, 2) - 0.5) * 0.05).astype(np.float32)).to(cuda)
    wv = tps.tps_coefficients(off, dims, inverse, order)
    cp = tps.tps_centres(off, dims, inverse).contiguous()
    got = cuda_kernels.tps_warp_fwd(vol, wv, cp, order)
    ref = tps._tps_warp_general_plain(vol, wv, cp, order)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol
    cuda_kernels.reset_launch_counts()
    tps.tps_warp(vol, off, dims, inverse, order)
    assert cuda_kernels.general_launch_count() == 1
    assert cuda_kernels.launch_counts()["tps_warp_fwd"] == 1


def _general_spline(r, device, B, n, per_image, order):
    """(wv, centres) of a spline of n centres: from an offset grid where n
    is one (16: 4x4, 30: 6x5; the inverse mapping for per-image centres),
    else random centres in [0, 1]^2 and coefficients near the identity."""
    grids = {16: (4, 4), 30: (6, 5)}
    if n in grids:
        off = torch.from_numpy(((r.rand(B, n, 2) - 0.5) * 0.05).astype(np.float32)).to(device)
        return (tps.tps_coefficients(off, grids[n], per_image, order),
                tps.tps_centres(off, grids[n], per_image).contiguous())
    cp = r.rand(*((B, n, 2) if per_image else (n, 2)))
    wv = np.concatenate([r.randn(B, n, 2) * 0.02 / n,
                         np.broadcast_to([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], (B, 3, 2))
                         + r.randn(B, 3, 2) * 0.01], axis=1)
    return (torch.from_numpy(wv.astype(np.float32)).to(device),
            torch.from_numpy(cp.astype(np.float32)).to(device))


# (B, n_cp, C, dtype, shifted): B across the chunk of 8 (1, 7, 13), every
# width of the blend (C = 1 and 3 a channel at a time, 8 and 16 by words),
# and a bf16 source 2 bytes off its 16-byte alignment
GENERAL_SHAPES = [(1, 1, 1, torch.float32, False), (7, 16, 3, torch.float32, False),
                  (13, 30, 8, torch.float32, False), (13, 32, 16, torch.float32, False),
                  (7, 30, 8, torch.bfloat16, False), (13, 16, 8, torch.bfloat16, True)]


@pytest.mark.parametrize("per_image", [False, True], ids=["shared", "per-image"])
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_general_warp_entry_redesign_matches_plain(cuda, order, per_image):
    """B1's general entry at every instantiated order (1-4) and the generic
    one (5, 6), shared and per-image centres, over GENERAL_SHAPES at 37 x
    29 (H * W = 1073, not a multiple of the 256-thread block): within 2e-4
    of its plain version in f32 and 2e-2 in bf16, every value finite."""
    r = np.random.RandomState(10 * order + per_image)
    H, W = 37, 29
    for B, n, C, dtype, shifted in GENERAL_SHAPES:
        wv, cp = _general_spline(r, cuda, B, n, per_image, order)
        vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(cuda, dtype)
        if shifted:
            buf = torch.empty(vol.numel() + 1, device=cuda, dtype=dtype)
            vol = buf[1:].view(vol.shape).copy_(vol)
            assert vol.data_ptr() % 16 != 0
        got = cuda_kernels.tps_warp_fwd(vol, wv, cp, order)
        ref = tps._tps_warp_general_plain(vol, wv, cp, order)
        torch.cuda.synchronize()
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        err = (got.float() - ref.float()).abs().max().item()
        assert torch.isfinite(got.float()).all() and err <= tol, (B, n, C, dtype, shifted, err)


def test_tensor_parallel_step_matches_one_process(cuda, tmp_path):
    """One tiny expert step on a (1, 2) mesh of two gloo ranks on the card,
    17 leaves sharded (min_features 16), against one process on the card:
    the generator metrics, computed before the update, equal bit for bit
    (each rank computes the unsharded forward, the weights gathered
    exactly)."""
    import torch_dist

    conf = tiny_test_config()
    model = build_model(conf, device=cuda)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    r = np.random.RandomState(4)
    B, hw, nm = conf.batch_size, conf.input_hw, conf.num_masks

    def masks():
        lab = r.randint(0, nm + 1, size=(B,) + hw)
        return (lab[..., None] == np.arange(nm)).astype(np.float32)
    batch = {k: (r.rand(B, *hw, 1) * 2 - 1).astype(np.float32) for k in ("x1", "x2", "dx1", "dx2")}
    batch.update({k: masks() for k in ("m1", "m2", "dm1", "dm2")})
    torch.cuda.synchronize()
    ranks = torch_dist.Ranks(torch_dist.tp_first_step, 2, tmp_path, conf, sd, batch, 16)
    ref = torch_dist.tp_first_step(None, conf, sd, batch, 16)
    for got in ranks.join():
        assert got["sharded"] == 17
        for k, v in ref["metrics"].items():
            if not k.startswith("dis_"):
                assert got["metrics"][k] == v, k


def test_program_spans_on_the_device_traces_clock(cuda):
    """Under a CUDA-only profiler, as the benchmark's window: the spans
    record, the trace holds the CUDA runtime calls, a kernel launched in a
    span has its runtime call inside it, and the device's idle gap made by
    a 5 ms host sleep between two kernels lies in the span that slept,
    its middle within 100 us of the sleep's."""
    from benchmark.harness.trace import Trace, profiler

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tracing.clear()
    prof = profiler()
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled
        with tracing.span("launch"):
            torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        with tracing.span("gap"):
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            slept = time.time_ns()
            time.sleep(0.005)
            slept = (slept + time.time_ns()) // 2
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    finally:
        prof.stop()
    trace = Trace(prof, 1.0)
    assert trace.runtime
    spans = {s.name: s for s in tracing.spans()}
    assert set(spans) == {"launch", "gap"}
    spins = [d for d in trace.device if "spin" in d[0]]
    assert len(spins) == 3, [d[0] for d in trace.device]
    call_at = {c: t for t, _, c in trace.runtime}
    launch = spans["launch"]
    assert launch.start_ns <= call_at[spins[0][3]] <= launch.end_ns
    mid = (spins[1][2] + spins[2][1]) // 2
    assert spans["gap"].start_ns <= mid <= spans["gap"].end_ns
    assert abs(mid - slept) <= 100_000, (mid - slept) / 1e3
