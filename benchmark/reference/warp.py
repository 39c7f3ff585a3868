"""The two warps of the models in plain PyTorch: the thin-plate-spline warp
of the fuser (5 x 5 control grid, order 2, forward mapping, bilinear blend
with zero outside) and the nearest-neighbour rotation of the augmentation
(edge clamp, rounding half to even). Float32; the spline's constant system
is inverted once in float64 with numpy.
"""

import numpy as np
import torch

_EPSILON = 1e-10
CP_DIMS = (5, 5)


def _phi(r2):
    return 0.5 * r2 * torch.log(torch.clamp(r2, min=_EPSILON))


def _grid(dims):
    """Normalised (y, x) grid points in [0, 1], row-major, (n, 2) float64."""
    mesh = np.mgrid[tuple(slice(0, d) for d in dims)]
    return mesh.reshape(len(dims), -1).T.astype(np.float64) / (np.asarray(dims, np.float64) - 1.0)


def _system_inverse():
    grid = _grid(CP_DIMS)
    n = grid.shape[0]
    sq = (grid ** 2).sum(-1)[:, None] - 2.0 * grid @ grid.T + (grid ** 2).sum(-1)[None, :]
    a = 0.5 * sq * np.log(np.maximum(sq, _EPSILON))
    b = np.concatenate([grid, np.ones((n, 1))], axis=1)
    lhs = np.block([[a, b], [b.T, np.zeros((3, 3))]])
    return np.linalg.inv(lhs).astype(np.float32)


def sample_locations(cp_offsets, hw):
    """(B, H*W, 2) float32 (y, x) pixel locations of the spline that moves
    the control grid by `cp_offsets` (B, 25, 2)."""
    dev = cp_offsets.device
    cp = torch.from_numpy(_grid(CP_DIMS).astype(np.float32)).to(dev)
    warped = cp[None] + cp_offsets
    B = warped.shape[0]
    rhs = torch.cat([warped, warped.new_zeros((B, 3, 2))], dim=1)
    wv = torch.matmul(torch.from_numpy(_system_inverse()).to(dev), rhs)
    q = torch.from_numpy(_grid(hw).astype(np.float32)).to(dev)
    sq = (torch.sum(q * q, -1)[:, None] - 2.0 * (q @ cp.T) + torch.sum(cp * cp, -1)[None, :])
    basis = torch.cat([_phi(sq), q, torch.ones_like(q[:, :1])], dim=1)
    scale = torch.tensor([hw[0] - 1.0, hw[1] - 1.0], device=dev)
    return torch.matmul(basis, wv) * scale


def bilinear_sample(img, coords_yx):
    """img (B, H, W, C) at (B, M, 2) pixel locations; a corner outside the
    image contributes zero. Returns (B, M, C)."""
    B, H, W, C = img.shape
    y, x = coords_yx[..., 0], coords_yx[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    flat = img.reshape(B, H * W, C)

    def corner(yi, xi):
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        idx = (torch.clamp(yi, 0, H - 1).long() * W + torch.clamp(xi, 0, W - 1).long())
        vals = torch.gather(flat, 1, idx.unsqueeze(-1).expand(-1, -1, C))
        return vals * valid.unsqueeze(-1).to(img.dtype)

    return (corner(y0, x0) * ((1 - wy1) * (1 - wx1)).unsqueeze(-1)
            + corner(y0, x0 + 1) * ((1 - wy1) * wx1).unsqueeze(-1)
            + corner(y0 + 1, x0) * (wy1 * (1 - wx1)).unsqueeze(-1)
            + corner(y0 + 1, x0 + 1) * (wy1 * wx1).unsqueeze(-1))


def tps_warp(vol, cp_offsets):
    """vol (B, H, W, C) warped by the spline of `cp_offsets`, float32."""
    B, H, W, C = vol.shape
    locs = sample_locations(cp_offsets.float(), (H, W))
    return bilinear_sample(vol.float(), locs).reshape(B, H, W, C)


def rotate(arrays, thetas):
    """Each (B, H, W, C_i) array of `arrays` turned by the per-sample
    angles `thetas` (B,) in radians about the image centre: every output
    pixel takes the nearest source pixel, source = R(-theta)(dest - c) + c,
    clamped to the edge."""
    B, H, W, _ = arrays[0].shape
    dev = arrays[0].device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    dy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy
    dx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx
    th = thetas.float()
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    yi = torch.clamp(torch.round(c * dy - s * dx + cy), 0, H - 1).long()
    xi = torch.clamp(torch.round(s * dy + c * dx + cx), 0, W - 1).long()
    idx = (yi * W + xi).reshape(B, H * W, 1)
    return [torch.gather(a.reshape(B, H * W, a.shape[-1]), 1, idx.expand(-1, -1, a.shape[-1]))
            .reshape(a.shape) for a in arrays]
