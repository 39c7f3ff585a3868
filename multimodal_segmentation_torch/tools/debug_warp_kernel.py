"""Bisect the TPS warp: dump its flow stage per point and compare.

Port of the JAX package's tools/debug_warp_kernel.py. It runs the warp's
flow stage alone (ops/tps.py::tps_flow_stage: kernel B5 on the GPU, which
runs the fused warp kernel's own flow code, or its plain version on the
CPU) on two 192x192 images with seeded control-point offsets, and prints
five max differences: the flow in pixels, y and x, against
tps_sample_locations (the locations the warp's backward uses), and qy, qx
and phi_0 against numpy formulas. A flow that agrees here and a warp that
does not point at the blend, not the flow.

The flow is computed in f32 throughout, as the fused kernels compute it
(the JAX package's Pallas warp asks for precision=HIGHEST). The JAX
tool's own flow matmul does not: on a TPU it ran in bf16 passes, ~0.7 px
off, and only on a CPU in f32.

  python -m multimodal_segmentation_torch.tools.debug_warp_kernel          # GPU
  python -m multimodal_segmentation_torch.tools.debug_warp_kernel --device cpu
"""

import argparse
import sys

import numpy as np
import torch

from multimodal_segmentation_torch.ops import tps

B, H, W = 2, 192, 192


def main(argv=None):
    """Run the bisect on `--device` (default cuda; no fallback to the CPU).
    Returns {"flow_y", "flow_x", "qy", "qx", "phi0"}: each a max abs
    difference, the flow's in pixels."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("debug_warp_kernel: no CUDA device; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    r = np.random.RandomState(0)
    off = torch.from_numpy((r.rand(B, 25, 2).astype(np.float32) - 0.5) * 0.05).to(dev)
    wv = tps.tps_coefficients(off)
    cp = tps.control_grid((5, 5), dev)
    got = tps.tps_flow_stage(wv, cp, (H, W)).cpu().numpy()
    ref = tps.tps_sample_locations(off, (H, W)).cpu().numpy()

    q = np.arange(H * W)
    qy_ref = (q // W) / (H - 1.0)
    qx_ref = (q % W) / (W - 1.0)
    cp0 = cp[0].cpu().numpy().astype(np.float64)
    d2_ref = (qy_ref - cp0[0]) ** 2 + (qx_ref - cp0[1]) ** 2
    phi_ref = 0.5 * d2_ref * np.log(np.maximum(d2_ref, 1e-10))
    diffs = {
        "flow_y": float(np.max(np.abs(got[:, :, 0] - ref[:, :, 0]))),
        "flow_x": float(np.max(np.abs(got[:, :, 1] - ref[:, :, 1]))),
        "qy": float(np.max(np.abs(got[:, :, 2] - qy_ref))),
        "qx": float(np.max(np.abs(got[:, :, 3] - qx_ref))),
        "phi0": float(np.max(np.abs(got[:, :, 4] - phi_ref))),
    }
    for name, d in diffs.items():
        print("%s max diff: %s" % (name, d))
    return diffs


if __name__ == "__main__":
    main()
