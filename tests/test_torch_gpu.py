"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the training step at full width. JAX-free, because the
card's machine has no JAX and tests/conftest.py imports it; run there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips."""

import os
import shutil

import numpy as np
import pytest
import torch

from multimodal_segmentation_torch.config import dafnet_chaos, tiny_test_config
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.ops import augment, cuda_kernels, tps
from multimodal_segmentation_torch.ops.resample import bilinear_sample
from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state
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
    of the blend (1e-5 on inputs in [0, 1]), at the training shape: a flow
    that differed at all would flip floor() at pixel edges and move the
    output by the image's gradient."""
    B, H, W, C = 12, 192, 192, 8
    off, wv, cp = _flow_inputs(cuda, B)
    vol = torch.from_numpy(np.random.RandomState(1).rand(B, H, W, C).astype(np.float32)).to(cuda)
    locs = cuda_kernels.tps_flow_dbg(wv, cp, (H, W))[..., :2].contiguous()
    warped = cuda_kernels.tps_warp_fwd(vol, wv, cp)
    blended = bilinear_sample(vol, locs).reshape(B, H, W, C)
    torch.cuda.synchronize()
    assert (warped - blended).abs().max().item() <= 1e-5


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


GROUPS = ([1, 1, 4, 4], [1, 1, 4], [4, 4], [1, 1], [3], [2, 5, 1, 7])


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
