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

from multimodal_segmentation_torch.config import (
    cardiac_3d,
    dafnet_chaos,
    mmsdnet_chaos,
    tiny_test_config,
)
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.ops import augment, cuda_kernels, tps
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
    (rotations) and 2 (rounding: the loss and the fake pools) times."""
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
                                            "tps_flow_dbg": 0}
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
                                            "tps_flow_dbg": 0}
    assert dtypes == [torch.bfloat16, torch.bfloat16]
    assert all(v.dtype == torch.float32 and torch.isfinite(v).item() for v in metrics.values())
    state = [*model.parameters(), *model.buffers()]
    for opt in (ts.opt_gen, *ts.opt_disc.values()):
        state += [t for st in opt.state.values() for t in st.values() if t.dim() > 0]
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all().item() for t in state)


def test_tiny_executor_epoch_on_the_card(cuda, tmp_path):
    """One tiny executor epoch (3 steps, validation, image callback,
    checkpoint) on the card: every kernel of the path launches, B4 among
    them (the flow-stage dump B5 is on no training path), and
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
                                            "tps_flow_dbg": 0}
    assert batches == [36, 12]
    assert all(torch.isfinite(v).item() for v in metrics.values()), metrics
    assert any(not torch.equal(a, b) for a, b in zip(model.balancer.parameters(), bal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_mmsdnet_steps_run_through_the_kernels(cuda, dtype):
    """One mmsdnet_chaos step_supervised (with its Z-regressor update) and
    one step_discriminator at batch 6, 192x192: finite f32 metrics and
    launches 3/1/3/6 (B1: the loss's two fusion directions, the
    Z-regressor's two in one call, the pool's one; B4: two private heads in
    the loss, the Z-regressor and the pool)."""
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
                                            "tps_flow_dbg": 0}
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
    launches a step."""
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
                        "tps_flow_dbg": 0}


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
