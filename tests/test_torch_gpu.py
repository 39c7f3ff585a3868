"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the training step at full width. JAX-free, because the
card's machine has no JAX and tests/conftest.py imports it; run there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from multimodal_segmentation_torch.config import dafnet_chaos, tiny_test_config
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.ops import augment, cuda_kernels, tps
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
        (vol, locs, g.transpose(1, 2)),                # g not contiguous
        (vol.cpu(), locs, g),                          # device
    ]
    for args in bad_bwd:
        with pytest.raises(ValueError):
            cuda_kernels.tps_warp_bwd(*args)
    for args in ((vol.half(), locs), (vol, locs[:, :-1]), (vol.cpu(), locs)):
        with pytest.raises(ValueError):
            cuda_kernels.nearest_warp(*args)


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
    metrics, and the kernels launched 2 (warp), 1 (warp backward) and 3
    (rotations) times."""
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
    assert cuda_kernels.launch_counts() == {"tps_warp_fwd": 2, "tps_warp_bwd": 1, "nearest_warp": 3}
    assert all(torch.isfinite(v).item() for v in metrics.values()), metrics
    assert all(torch.equal(a, b) for a, b in zip(model.balancer.parameters(), bal))
