"""Thin-plate-spline warping (the STN of the anatomy fuser), forward mapping.

Port of multimodal_segmentation_tpu/ops/tps.py (reference
layers/stn_spline.py:38-67, layers/interpolate_spline.py:76-179):

  f(q) = sum_i w_i * phi(||q - c_i||^2) + [q, 1] @ v
  phi(r2) = 0.5 * r2 * log(max(r2, eps))           (thin-plate, order 2)

with (w, v) from [[A, B], [B^T, 0]] [w; v] = [f; 0]. In the forward
direction the centres are the regular control grid, so the system matrix
is constant: its float64 inverse is computed once on the host and the
per-sample solve becomes one small f32 matmul.

`tps_warp` dispatches by device. For a tensor on the GPU it is a
torch.autograd.Function: the forward launches the fused CUDA kernel
(ops/cuda_kernels.py::tps_warp_fwd), the backward the warp-backward
kernel (tps_warp_bwd) and chains its location gradient to the offsets
through autograd of `tps_sample_locations`, as the JAX package's
custom_vjp does (ops/tps.py:268-288). For a tensor on the CPU it is the
plain version (`_tps_warp_plain`: sample locations + bilinear gather),
differentiated by autograd. The flow stays f32 throughout;
reduced-precision matmul passes cost ~0.7 px of flow at 192^2.
"""

import functools

import numpy as np
import torch

from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_bwd, tps_warp_fwd
from multimodal_segmentation_torch.ops.resample import bilinear_sample

_EPSILON = 1e-10  # matches reference layers/interpolate_spline.py:27


def _phi(r2):
    """Thin-plate radial basis (order 2) on *squared* distances."""
    return 0.5 * r2 * torch.log(torch.clamp(r2, min=_EPSILON))


def _sq_dist(x, y):
    """Pairwise squared distances between rows of x (n,d) and y (m,d), in
    the expanded form of the JAX package (ops/tps.py:50-54)."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    yn = torch.sum(y * y, dim=-1)[None, :]
    return xn - 2.0 * (x @ y.T) + yn


@functools.lru_cache(maxsize=None)
def _control_grid_np(dims):
    mesh = np.mgrid[tuple(slice(0, d) for d in dims)]
    grid = np.ascontiguousarray(mesh.reshape(len(dims), -1).T, dtype=np.float32)
    return grid / (np.asarray(dims, dtype=np.float32) - 1.0)


@functools.lru_cache(maxsize=None)
def _constant(make, key, device):
    """make(key), a numpy array, as a tensor on `device`: copied there once
    per device, so a training step sends no host tensor to the card. Made
    outside inference mode, since autograd may save it for backward. The
    tensor is shared by every caller: read only."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(key)).to(device)


def control_grid(dims, device="cpu"):
    """Normalised n-D grid of control/query points, row-major (y, x) order:
    dims=(5, 5) gives a (25, 2) f32 tensor with coordinates in [0, 1]
    (reference layers/stn_spline.py:70-91). Shared and read only."""
    return _constant(_control_grid_np, tuple(dims), torch.device(device))


def _pixel_scale_np(vol_shape):
    """(H - 1, W - 1): normalised (y, x) -> pixel coordinates."""
    return np.asarray([vol_shape[0] - 1, vol_shape[1] - 1], np.float32)


@functools.lru_cache(maxsize=None)
def _const_tps_inverse(cp_dims):
    """Float64 inverse of the constant forward TPS system matrix, cast to
    f32 (multimodal_segmentation_tpu/ops/tps.py:101-142)."""
    mesh = np.mgrid[tuple(slice(0, d) for d in cp_dims)]
    grid = mesh.reshape(len(cp_dims), -1).T.astype(np.float64)
    grid = grid / (np.asarray(cp_dims, dtype=np.float64) - 1.0)
    n, d = grid.shape
    sq = (
        (grid**2).sum(-1)[:, None]
        - 2.0 * grid @ grid.T
        + (grid**2).sum(-1)[None, :]
    )
    a = 0.5 * sq * np.log(np.maximum(sq, _EPSILON))
    b = np.concatenate([grid, np.ones((n, 1))], axis=1)
    lhs = np.block([[a, b], [b.T, np.zeros((d + 1, d + 1))]])
    return np.linalg.inv(lhs).astype(np.float32)


def _forward_coefficients(cp_offsets, cp_dims):
    """Batched [w; v] coefficients (B, n+d+1, d) for the mapping from the
    control grid to the offset grid, via the constant inverse."""
    device = cp_offsets.device
    warped = control_grid(cp_dims, device)[None] + cp_offsets   # (B, n, d)
    B, n, d = warped.shape
    rhs = torch.cat([warped, warped.new_zeros((B, d + 1, d))], dim=1)
    inv = _constant(_const_tps_inverse, tuple(cp_dims), device)
    return torch.matmul(inv, rhs).contiguous()


def tps_coefficients(cp_offsets, cp_dims=(5, 5)):
    """Stacked coefficients (B, n_cp + 3, 2) = [w; v] for the flow."""
    return _forward_coefficients(cp_offsets, tuple(cp_dims))


def tps_sample_locations(cp_offsets, vol_shape, cp_dims=(5, 5)):
    """Dense per-pixel sample locations for a batch of control-point offsets.

    Args:
      cp_offsets: (B, n_cp, 2) f32 offsets of the control points, in
        normalised [0, 1] grid coordinates, (y, x) order.
      vol_shape: (H, W) of the image being warped.

    Returns:
      (B, H*W, 2) f32 pixel-space sample locations in (y, x) order.
    """
    device = cp_offsets.device
    cp_grid = control_grid(cp_dims, device)
    q_grid = control_grid(vol_shape, device)
    wv = _forward_coefficients(cp_offsets, tuple(cp_dims))
    phi_q = _phi(_sq_dist(q_grid, cp_grid))                       # (m, n)
    basis = torch.cat([phi_q, q_grid, torch.ones_like(q_grid[:, :1])], dim=1)
    locs = torch.matmul(basis, wv)                                # (B, m, 2)
    return locs * _constant(_pixel_scale_np, tuple(vol_shape), device)


def _tps_warp_plain(vol, cp_offsets, cp_dims=(5, 5)):
    """Plain PyTorch version of the warp: sample locations + bilinear gather."""
    B, H, W, C = vol.shape
    locs = tps_sample_locations(cp_offsets, (H, W), cp_dims)
    return bilinear_sample(vol, locs).reshape(B, H, W, C).to(vol.dtype)


def _tps_warp_bwd_plain(vol, locs, g):
    """Plain PyTorch version of the warp backward (kernel tps_warp_bwd):
    autograd of the bilinear gather with respect to (vol, locs). floor()
    has zero gradient, so this is the same function as the kernel's.
    Returns (grad_vol in vol's dtype, grad_locs f32)."""
    B, H, W, C = vol.shape
    with torch.enable_grad():
        v = vol.detach().float().requires_grad_(True)
        l = locs.detach().float().requires_grad_(True)
        out = bilinear_sample(v, l)
        gv, gl = torch.autograd.grad(out, (v, l), g.reshape(B, H * W, C).float())
    return gv.to(vol.dtype), gl


class _TPSWarpCUDA(torch.autograd.Function):
    """tps_warp on the GPU: kernel forward, kernel backward for the
    gather, autograd for the small chain from the locations to the
    control-point offsets (28x28 solve, flow matmul)."""

    @staticmethod
    def forward(ctx, vol, cp_offsets, cp_dims):
        ctx.cp_dims = cp_dims
        ctx.save_for_backward(vol, cp_offsets)
        wv = tps_coefficients(cp_offsets, cp_dims)
        return tps_warp_fwd(vol, wv, control_grid(cp_dims, vol.device))

    @staticmethod
    def backward(ctx, g):
        vol, cp_offsets = ctx.saved_tensors
        B, H, W, C = vol.shape
        with torch.enable_grad():
            off = cp_offsets.detach().requires_grad_(True)
            locs = tps_sample_locations(off, (H, W), ctx.cp_dims)
        # g arrives through the fuser's permute, channels-first: the kernel
        # reads it through its strides, with no contiguous copy
        grad_vol, grad_locs = tps_warp_bwd(vol, locs.detach(), g)
        grad_off = None
        if ctx.needs_input_grad[1]:
            (grad_off,) = torch.autograd.grad(locs, off, grad_locs)
        return (grad_vol if ctx.needs_input_grad[0] else None), grad_off, None


def tps_warp(vol, cp_offsets, cp_dims=(5, 5)):
    """Warp a batch of images with a thin-plate-spline deformation.

    Args:
      vol: (B, H, W, C) images, f32 or bf16.
      cp_offsets: (B, n_cp, 2) f32 control-point offsets (normalised, (y, x)).

    Returns:
      (B, H, W, C) warped images in vol's dtype (zeros where sampling falls
      outside). On the GPU this launches the CUDA kernel, and its gradient
      the backward kernel; on the CPU it runs the plain version.
    """
    if vol.device.type == "cuda":
        return _TPSWarpCUDA.apply(vol, cp_offsets, tuple(cp_dims))
    if vol.device.type != "cpu":
        raise ValueError("tps_warp runs on 'cuda' or 'cpu', got %s" % vol.device)
    return _tps_warp_plain(vol, cp_offsets, cp_dims)
