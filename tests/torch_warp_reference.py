"""Float64 reference for the gradient of the TPS warp with respect to the
control-point offsets. JAX-free, so the card's tests (tests/test_torch_gpu.py)
use it as well as the CPU ones.

The sample locations are linear in the offsets,
    locs[b, m, d] = scale_d * sum_i (basis @ inv)[m, i] * (cp + off)[b, i, d],
so the chain from the locations to the offsets is a fixed matrix. It is
evaluated here in float64 from the f32 path's own basis and inverse, and
the location gradient in float64 at the f32 locations, where no floor()
can flip.
"""

import torch

from multimodal_segmentation_torch.ops import tps
from multimodal_segmentation_torch.ops.resample import bilinear_sample


def offsets_chain_f64(H, W, device, cp_dims=(5, 5)):
    """g (B, H*W, 2) -> the offsets' gradient (B, n_cp, 2), exactly, in
    float64; and the same map on magnitudes, |d locs / d off|^T |g|."""
    q, cp = tps.control_grid((H, W), device), tps.control_grid(cp_dims, device)
    basis = torch.cat([tps._phi(tps._sq_dist(q, cp)), q, torch.ones_like(q[:, :1])], 1)
    inv = torch.from_numpy(tps._const_tps_inverse(tuple(cp_dims))).to(device)
    a = (basis.double() @ inv.double())[:, :cp.shape[0]]
    scale = torch.tensor([H - 1.0, W - 1.0], dtype=torch.float64, device=device)

    def chain(g):
        return torch.einsum("mi,bmd->bid", a, g.double()) * scale

    def magnitudes(g):
        return torch.einsum("mi,bmd->bid", a.abs(), g.double().abs()) * scale

    return chain, magnitudes


def offsets_gradient_reference(vol, off, w):
    """For loss = sum(tps_warp(vol, off) * w), with vol and w (B, H, W, C):
    the exact chain (see offsets_chain_f64), the float64 gradient with
    respect to `off`, and how many times the largest sum of the terms'
    magnitudes exceeds the largest entry of that gradient."""
    B, H, W, C = vol.shape
    locs = tps.tps_sample_locations(off, (H, W))
    l64 = locs.double().requires_grad_(True)
    (gl64,) = torch.autograd.grad(bilinear_sample(vol.double(), l64), l64,
                                  w.double().reshape(B, H * W, C))
    chain, magnitudes = offsets_chain_f64(H, W, vol.device)
    ref = chain(gl64)
    spread = (magnitudes(gl64).max() / ref.abs().max()).item()
    return chain, ref, spread
