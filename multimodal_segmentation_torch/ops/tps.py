"""Thin-plate-spline warping (the STN of the anatomy fuser).

Port of multimodal_segmentation_tpu/ops/tps.py (reference
layers/stn_spline.py:38-67, layers/interpolate_spline.py:76-209):

  f(q) = sum_i w_i * phi(||q - c_i||^2) + [q, 1] @ v
  phi(r2) = 0.5 * r2 * log(max(r2, eps))           (thin-plate, order 2;
            other orders as `_phi`)

with (w, v) from [[A, B], [B^T, 0]] [w; v] = [f; 0]. In the forward
direction (inverse=False, every caller's) the centres are the regular
control grid, so the system matrix is constant: its float64 inverse is
computed once on the host and the per-sample solve becomes one small f32
matmul. The inverse mapping centres the spline at the warped control
points instead, so each sample solves its own (n+3) x (n+3) system, in
f32 with torch.linalg.solve, as the JAX package's jnp route does
(solve_tps, _interpolate). The JAX package's Pallas route ignores
`inverse` and `order` (it passes the regular grid as the centres and
hard-codes the order-2 basis); the port follows the jnp route on every
device.

`tps_warp` dispatches by device. For a tensor on the GPU it is a
torch.autograd.Function: the forward launches the fused CUDA kernel
(ops/cuda_kernels.py::tps_warp_fwd) with the coefficients and the
centres, the backward the warp-backward kernel (tps_warp_bwd) and chains
its location gradient to the offsets through autograd of
`tps_sample_locations` (the solve included), as the JAX package's
custom_vjp does (ops/tps.py:268-288). For a tensor on the CPU it is the
plain version (`_tps_warp_plain`: sample locations + bilinear gather),
differentiated by autograd. The flow stays f32 throughout;
reduced-precision matmul passes cost ~0.7 px of flow at 192^2.

`tps_flow_stage` is the warp's flow stage alone, per point, for bisecting
the warp: on the GPU kernel B5 (cuda_kernels.tps_flow_dbg, which runs the
fused kernel's own flow code), on the CPU `_tps_flow_stage_plain`.
"""

import functools

import numpy as np
import torch

from multimodal_segmentation_torch.ops.cuda_kernels import tps_flow_dbg, tps_warp_bwd, tps_warp_fwd
from multimodal_segmentation_torch.ops.resample import bilinear_sample

_EPSILON = 1e-10  # matches reference layers/interpolate_spline.py:27


def _phi(r2, order=2):
    """Polyharmonic radial basis on *squared* distances (JAX ops/tps.py:
    32-47, reference layers/interpolate_spline.py:182-209)."""
    if order == 1:
        return torch.sqrt(torch.clamp(r2, min=_EPSILON))
    if order == 2:
        return 0.5 * r2 * torch.log(torch.clamp(r2, min=_EPSILON))
    if order == 4:
        return 0.5 * torch.square(r2) * torch.log(torch.clamp(r2, min=_EPSILON))
    r2 = torch.clamp(r2, min=_EPSILON)
    if order % 2 == 0:
        return 0.5 * torch.pow(r2, 0.5 * order) * torch.log(r2)
    return torch.pow(r2, 0.5 * order)


def _sq_dist(x, y):
    """Pairwise squared distances between rows of x (n,d) and y (m,d), or
    (B, m, d) for one set of rows per sample, in the expanded form of the
    JAX package (ops/tps.py:50-54)."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    yn = torch.sum(y * y, dim=-1).unsqueeze(-2)
    return xn - 2.0 * (x @ y.transpose(-1, -2)) + yn


@functools.lru_cache(maxsize=None)
def _control_grid_np(dims):
    mesh = np.mgrid[tuple(slice(0, d) for d in dims)]
    grid = np.ascontiguousarray(mesh.reshape(len(dims), -1).T, dtype=np.float32)
    return grid / (np.asarray(dims, dtype=np.float32) - 1.0)


@functools.lru_cache(maxsize=None)
def _constant(make, device, *key):
    """make(*key), a numpy array, as a tensor on `device`: copied there once
    per device, so a training step sends no host tensor to the card. Made
    outside inference mode, since autograd may save it for backward. The
    tensor is shared by every caller: read only."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*key)).to(device)


def control_grid(dims, device="cpu"):
    """Normalised n-D grid of control/query points, row-major (y, x) order:
    dims=(5, 5) gives a (25, 2) f32 tensor with coordinates in [0, 1]
    (reference layers/stn_spline.py:70-91). Shared and read only."""
    return _constant(_control_grid_np, torch.device(device), tuple(dims))


def _pixel_scale_np(vol_shape):
    """(H - 1, W - 1): normalised (y, x) -> pixel coordinates."""
    return np.asarray([vol_shape[0] - 1, vol_shape[1] - 1], np.float32)


@functools.lru_cache(maxsize=None)
def _const_tps_inverse(cp_dims, order=2):
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
    a = _phi(torch.from_numpy(sq), order).numpy()
    b = np.concatenate([grid, np.ones((n, 1))], axis=1)
    lhs = np.block([[a, b], [b.T, np.zeros((d + 1, d + 1))]])
    return np.linalg.inv(lhs).astype(np.float32)


def _forward_coefficients(cp_offsets, cp_dims, order=2):
    """Batched [w; v] coefficients (B, n+d+1, d) for the mapping from the
    control grid to the offset grid, via the constant inverse."""
    device = cp_offsets.device
    warped = control_grid(cp_dims, device)[None] + cp_offsets   # (B, n, d)
    B, n, d = warped.shape
    rhs = torch.cat([warped, warped.new_zeros((B, d + 1, d))], dim=1)
    inv = _constant(_const_tps_inverse, device, tuple(cp_dims), order)
    return torch.matmul(inv, rhs).contiguous()


def _inverse_coefficients(cp_offsets, cp_dims, order=2):
    """Batched [w; v] (B, n+d+1, d) of the inverse mapping: the spline
    centred at each sample's warped control points that maps them back to
    the control grid, one f32 solve a sample (JAX ops/tps.py:70-100,
    solve_tps, vmapped in tps_coefficients :218-231)."""
    cp = control_grid(cp_dims, cp_offsets.device).to(cp_offsets.dtype)
    centres = cp[None] + cp_offsets                               # (B, n, d)
    B, n, d = centres.shape
    a = _phi(_sq_dist_batched(centres), order)                    # (B, n, n)
    b = torch.cat([centres, torch.ones_like(centres[..., :1])], dim=-1)   # (B, n, d+1)
    lhs = torch.cat([torch.cat([a, b], dim=-1),
                     torch.cat([b.transpose(1, 2), a.new_zeros((B, d + 1, d + 1))], dim=-1)],
                    dim=1)
    rhs = torch.cat([cp, cp.new_zeros((d + 1, d))], dim=0).expand(B, -1, -1)
    return torch.linalg.solve(lhs, rhs).contiguous()


def _sq_dist_batched(x):
    """_sq_dist of each sample's rows with themselves: (B, n, d) ->
    (B, n, n). The cross term is summed from rounded products, as the sums
    of squares are, so the diagonal is exactly 0: a matmul that fuses
    multiply and add leaves ~1e-8 there, which order 1's sqrt turns into
    ~2e-3 px of the inverse mapping."""
    xn = torch.sum(x * x, dim=-1)
    cross = torch.sum(x[:, :, None, :] * x[:, None, :, :], dim=-1)
    return xn[:, :, None] - 2.0 * cross + xn[:, None, :]


def tps_centres(cp_offsets, cp_dims=(5, 5), inverse=False):
    """The spline's centres: the control grid (n_cp, 2), shared by the
    batch, or with `inverse` each sample's warped control points
    (B, n_cp, 2)."""
    cp = control_grid(cp_dims, cp_offsets.device)
    return cp[None] + cp_offsets if inverse else cp


def tps_coefficients(cp_offsets, cp_dims=(5, 5), inverse=False, order=2):
    """Stacked coefficients (B, n_cp + 3, 2) = [w; v] for the flow."""
    if inverse:
        return _inverse_coefficients(cp_offsets, tuple(cp_dims), order)
    return _forward_coefficients(cp_offsets, tuple(cp_dims), order)


def tps_sample_locations(cp_offsets, vol_shape, cp_dims=(5, 5), inverse=False, order=2):
    """Dense per-pixel sample locations for a batch of control-point offsets.

    Args:
      cp_offsets: (B, n_cp, 2) f32 offsets of the control points, in
        normalised [0, 1] grid coordinates, (y, x) order.
      vol_shape: (H, W) of the image being warped.
      cp_dims: the control grid, n_cp = cp_dims[0] * cp_dims[1].
      inverse: fit the inverse mapping (centres at the warped points).
      order: the polyharmonic order of the radial basis (`_phi`).

    Returns:
      (B, H*W, 2) f32 pixel-space sample locations in (y, x) order.
    """
    device = cp_offsets.device
    q_grid = control_grid(vol_shape, device).to(cp_offsets.dtype)
    wv = tps_coefficients(cp_offsets, cp_dims, inverse, order)
    centres = tps_centres(cp_offsets, cp_dims, inverse)
    phi_q = _phi(_sq_dist(q_grid, centres), order)                # (m, n) or (B, m, n)
    if inverse:
        q_pad = torch.cat([q_grid, torch.ones_like(q_grid[:, :1])], dim=1)
        basis = torch.cat([phi_q, q_pad.expand(phi_q.shape[0], -1, -1)], dim=2)
    else:
        basis = torch.cat([phi_q, q_grid, torch.ones_like(q_grid[:, :1])], dim=1)
    locs = torch.matmul(basis, wv)                                # (B, m, 2)
    return locs * _constant(_pixel_scale_np, device, tuple(vol_shape))


def _tps_warp_plain(vol, cp_offsets, cp_dims=(5, 5), inverse=False, order=2):
    """Plain PyTorch version of the warp: sample locations + bilinear gather."""
    B, H, W, C = vol.shape
    locs = tps_sample_locations(cp_offsets, (H, W), cp_dims, inverse, order)
    return bilinear_sample(vol, locs).reshape(B, H, W, C).to(vol.dtype)


def _general_locations(wv, centres, vol_shape, order=2):
    """The sample locations (B, H*W, 2) of the warp kernel's general entry:
    from f32 coefficients (B, n_cp + 3, 2) and centres ((n_cp, 2) or
    (B, n_cp, 2)), the flow with direct differences q - c_i in float64, as
    the kernel evaluates it, rounded to f32 pixel locations."""
    H, W = vol_shape
    B, n = wv.shape[0], wv.shape[1] - 3
    q = control_grid((H, W), wv.device).double()                        # (m, 2)
    c = centres.double()
    c = c.expand(B, -1, -1) if c.dim() == 2 else c
    d = q[None, :, None, :] - c[:, None, :, :]                          # (B, m, n, 2)
    phi = _phi(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], order)    # (B, m, n)
    w = wv.double()
    flow = phi @ w[:, :n] + q @ w[:, n:n + 2] + w[:, n + 2:n + 3]        # (B, m, 2)
    scale = torch.tensor([H - 1.0, W - 1.0], dtype=torch.float64, device=wv.device)
    return (flow * scale).float()


def _tps_warp_general_plain(vol, wv, centres, order=2):
    """Plain PyTorch version of the warp kernel's general entry
    (cuda_kernels.tps_warp_fwd for anything but the 25-point order-2 shared
    grid): the f32 bilinear blend at _general_locations."""
    B, H, W, C = vol.shape
    locs = _general_locations(wv, centres, (H, W), order)
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
    control-point offsets (the (n+3)-square solve, the flow matmul)."""

    @staticmethod
    def forward(ctx, vol, cp_offsets, cp_dims, inverse, order):
        ctx.args = (cp_dims, inverse, order)
        ctx.save_for_backward(vol, cp_offsets)
        wv = tps_coefficients(cp_offsets, cp_dims, inverse, order)
        centres = tps_centres(cp_offsets, cp_dims, inverse).contiguous()
        return tps_warp_fwd(vol, wv, centres, order)

    @staticmethod
    def backward(ctx, g):
        vol, cp_offsets = ctx.saved_tensors
        B, H, W, C = vol.shape
        with torch.enable_grad():
            off = cp_offsets.detach().requires_grad_(True)
            locs = tps_sample_locations(off, (H, W), *ctx.args)
        # g arrives through the fuser's permute, channels-first: the kernel
        # reads it through its strides, with no contiguous copy
        grad_vol, grad_locs = tps_warp_bwd(vol, locs.detach(), g)
        grad_off = None
        if ctx.needs_input_grad[1]:
            (grad_off,) = torch.autograd.grad(locs, off, grad_locs)
        return (grad_vol if ctx.needs_input_grad[0] else None), grad_off, None, None, None


def tps_warp(vol, cp_offsets, cp_dims=(5, 5), inverse=False, order=2):
    """Warp a batch of images with a thin-plate-spline deformation.

    Args:
      vol: (B, H, W, C) images, f32 or bf16.
      cp_offsets: (B, n_cp, 2) f32 control-point offsets (normalised, (y, x)).
      cp_dims: the control grid; on the GPU n_cp = cp_dims[0] * cp_dims[1]
        is at most 32 (the kernel's limit; the JAX kernel's too).
      inverse, order: as tps_sample_locations.

    Returns:
      (B, H, W, C) warped images in vol's dtype (zeros where sampling falls
      outside). On the GPU this launches the CUDA kernel, and its gradient
      the backward kernel; on the CPU it runs the plain version.
    """
    if vol.device.type == "cuda":
        if cp_offsets.shape[1] > 32:
            raise ValueError("tps_warp on the GPU takes at most 32 control points (the "
                             "kernel's limit, as the JAX package's), got %d"
                             % cp_offsets.shape[1])
        return _TPSWarpCUDA.apply(vol, cp_offsets, tuple(cp_dims), bool(inverse), int(order))
    if vol.device.type != "cpu":
        raise ValueError("tps_warp runs on 'cuda' or 'cpu', got %s" % vol.device)
    return _tps_warp_plain(vol, cp_offsets, cp_dims, inverse, order)


def _tps_flow_stage_plain(wv, cp, vol_shape):
    """Plain PyTorch version of the flow-stage dump (kernel tps_flow_dbg):
    the fused kernel's flow formula and order, term by term, with direct
    differences q - c_i (not _sq_dist's expanded form), in f32.

    Args:
      wv: (B, n_cp + 3, 2) f32 coefficients [w; v] (tps_coefficients).
      cp: (n_cp, 2) f32 control points, (y, x).
      vol_shape: (H, W).

    Returns:
      (B, H*W, 5) f32: flow_y * (H-1), flow_x * (W-1), qy, qx, phi_0.
    """
    H, W = vol_shape
    B, n_cp = wv.shape[0], cp.shape[0]
    q = torch.arange(H * W, device=wv.device)
    qi = torch.div(q, W, rounding_mode="floor")
    qy = qi.float() / float(H - 1)
    qx = (q - qi * W).float() / float(W - 1)
    fy = wv.new_zeros(B, H * W)
    fx = wv.new_zeros(B, H * W)
    for i in range(n_cp):
        dy = qy - cp[i, 0]
        dx = qx - cp[i, 1]
        d2 = dy * dy + dx * dx
        phi = 0.5 * d2 * torch.log(torch.clamp(d2, min=_EPSILON))
        if i == 0:
            phi0 = phi
        fy = fy + phi * wv[:, i, 0:1]
        fx = fx + phi * wv[:, i, 1:2]
    v = wv[:, n_cp:]   # rows multiply qy, qx, 1
    fy = fy + (qy * v[:, 0, 0:1] + qx * v[:, 1, 0:1] + v[:, 2, 0:1])
    fx = fx + (qy * v[:, 0, 1:2] + qx * v[:, 1, 1:2] + v[:, 2, 1:2])
    per_point = torch.stack([qy, qx, phi0], -1).expand(B, -1, -1)
    return torch.cat([torch.stack([fy * float(H - 1), fx * float(W - 1)], -1), per_point], -1)


def tps_flow_stage(wv, cp, vol_shape):
    """The warp's flow stage alone, per output point: what tps_warp blends at.

    Args:
      wv: (B, 28, 2) f32 coefficients [w; v] (tps_coefficients).
      cp: (25, 2) f32 control points (control_grid((5, 5))), on wv's device.
      vol_shape: (H, W) of the image the flow warps.

    Returns:
      (B, H*W, 5) f32: per point the flow in pixels (y, x), the normalised
      query point (qy, qx) and the first radial basis term phi_0. On the
      GPU this launches kernel B5, on the CPU it runs the plain version.
    """
    if wv.device.type == "cuda":
        return tps_flow_dbg(wv, cp, vol_shape)
    if wv.device.type != "cpu":
        raise ValueError("tps_flow_stage runs on 'cuda' or 'cpu', got %s" % wv.device)
    return _tps_flow_stage_plain(wv, cp, vol_shape)
