#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (multimodal_segmentation_torch) on one GPU and
check what comes out.

Phases, one JSON line each:
  env           the card's name and count, nvidia-smi's name and power
                limit, torch and CUDA versions, both TF32 flags
  build         every CUDA kernel built from csrc/ (one nvcc per source, all
                started together): seconds, ptxas register/spill lines
  kernels       each kernel at the main path's shapes against its plain
                PyTorch version: max abs error; per timed call `ms` (CUDA
                events around 60 queued calls), `device_ms` (what the card
                ran for a call, summed from a torch.profiler window),
                `host_ms` (host time to enqueue a call), the bound, the
                plain version's time and the library call's `library_ms`,
                `library_device_ms` and `library_host_ms` (tps_warp_fwd;
                tps_warp_bwd with small, large, zero, scattered,
                window-edge and border locations, g contiguous and
                channels-first; `rotation`: a training step's three
                group rotations, kernel and whole random_rotate_batch
                path, with wall times; round_ste; `launch_path`: host us
                of each part of a wrapper's launch; `flow`: tps_flow_dbg
                at the tool's shape and at B1's, the stages check of B1
                against a plain blend at its locations, the gap to
                tps_sample_locations, B5's share of B1's device time)
  debug-warp    the warp-bisect tool (multimodal_segmentation_torch.tools.
                debug_warp_kernel) on the card: its five max differences
                and the kernel launches of that run
  slice         ModelTester on the synthetic loader's split-0 test volumes,
                modality t2, fusions simple/def/max on expert and randomised
                pairs, at full dafnet_chaos width with seeded weights: Dice
                per fusion, per-volume p50 latency, kernel launches, peak
                device memory
  cross-device  predict_mask(1, 'max') on two slices on the card and on the
                CPU with the same weights: share of pixels whose argmax
                differs, max probability difference elsewhere
  train         DAFNetSteps.step_supervised at full dafnet_chaos width
                (batch 6, 192x192, f32) on expert batches from the synthetic
                loader's split-0 training data: every metric of every step,
                ms per step and slices/s, kernel launches per step (2/1/3/2),
                peak device memory, which parameters moved
  train-cross-device
                one step_supervised at the tiny config on the card and on
                the CPU, same weights, batch and noise: relative difference
                of each metric
  experiment    the training executor at full dafnet_chaos width through the
                CLI's config (--l_mix 0.5, synthetic data, 12 steps an epoch,
                SWA from epoch 1): 3 epochs, a resume in a new executor to
                epoch 4, then `--test` through the CLI on the same folder:
                ms per epoch (training part), of validation, of a
                checkpoint save, of the component export and of the image
                callback; checkpoint bytes, kernel launches, validation
                logs, test Dice, peak memory, artifacts, the SWA check

Then nvidia-smi's name/power line, the kernels summary and, last, the result
line. Any failed check raises, and the script exits non-zero without a
result line; so it does without a CUDA device, or outside the repository.

  python3 chip_smoke.py                  # needs one CUDA device
  python3 chip_smoke.py --cpu-rehearsal  # slice, cross-device, train,
                                         # debug-warp and experiment at the
                                         # tiny config on the CPU with the
                                         # plain versions; no result line
  python3 chip_smoke.py --profile-train  # only a torch.profiler window over
                                         # full-width train steps on the card:
                                         # device time by kernel and by kind,
                                         # busy share; no result line
"""

import argparse
import csv
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# seeded weights that make inference exercise the warp: a sharper anatomy
# head (at init every softmax channel is < 0.5 and the rounded anatomy is
# empty) and a non-zero last LocNet Dense (zero at init: identity warp)
ANATOMY_GAIN = 5.0
DENSE1_STD = 1e-2
# train phase: 2 warm-up steps, then timed steps
TRAIN_WARMUP = 2
TRAIN_STEPS = 12
# experiment phase: steps an epoch, epochs before and after the resume
EXP_STEPS = 12
EXP_EPOCHS = 3
EXP_RESUME_EPOCHS = 4


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(out != "", "nvidia-smi printed nothing")
    return out


def time_ms(fn, iters=60, warmup=5, reps=5):
    """ms per call, CUDA events: the median over `reps` runs of `iters`
    calls each (after `warmup` calls), and the [min, max] of the runs."""
    import torch

    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    runs.sort()
    return runs[len(runs) // 2], [runs[0], runs[-1]]


def host_ms(fn, iters=200):
    """ms of host time per call to enqueue `iters` calls, without waiting
    for the device: where it reaches the device time, the host's launch
    path, not the kernel, sets the timed rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    out = 1e3 * (time.perf_counter() - t) / iters
    torch.cuda.synchronize()
    return out


def device_rows(prof):
    """[(self device us, name, count)] of the CUDA activity (kernels,
    memsets, copies) in a torch.profiler window, largest first."""
    rows = []
    for e in prof.key_averages():
        # user annotations (e.g. "Optimizer.step#Adam.step") span kernels
        # that are rows of their own; kernel names hold "#" only inside
        # brackets ("{lambda(int)#1}")
        if getattr(e, "is_user_annotation", False) or re.fullmatch(r"[\w.]+#[\w.]+", e.key):
            continue
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    return rows


def device_ms(fn, iters=30, tries=3):
    """ms of device time per call: everything the card ran for `iters`
    calls (every kernel, memset and copy a call launches), summed from a
    torch.profiler window, over `iters`. Unlike time_ms it leaves out the
    gaps in which the device waits for the host. A window in which the
    profiler recorded no device activity at all (seen once in ~40 windows
    on the H100 machine) is taken again, up to `tries` windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(r[0] for r in device_rows(prof))
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("chip_smoke check failed: the profiler saw no device time "
                       "in %d windows" % tries)


def rotating(tensors_fn, nbytes, floor=160 * 2 ** 20):
    """Enough copies of the inputs that consecutive calls miss the 50 MB L2."""
    return [tensors_fn() for _ in range(max(2, -(-floor // nbytes)))]


def measure(bufs, kernel, plain, library, moved, flops, plain_iters=10):
    """Time kernel(buf), plain(buf) and library(buf), each call on the next
    of the rotating buffers `bufs`, and the bound of the work: the larger of
    `moved` bytes over the HBM rate and `flops` over the f32 rate. Where no
    PyTorch call computes the function, `library` is None and so are its
    times."""
    def cycled(fn):
        it = itertools.cycle(bufs)
        return lambda: fn(next(it))

    ms, ms_spread = time_ms(cycled(kernel))
    plain_ms, plain_spread = time_ms(cycled(plain), iters=plain_iters)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    out = {
        "ms": ms, "ms_spread": ms_spread,
        "device_ms": device_ms(cycled(kernel)),
        "host_ms": host_ms(cycled(kernel)),
        "plain_ms": plain_ms, "plain_ms_spread": plain_spread,
        "library_ms": None, "library_ms_spread": None,
        "library_device_ms": None, "library_host_ms": None, "host_over_library_host": None,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved, "flops": flops,
    }
    if library is not None:
        out["library_ms"], out["library_ms_spread"] = time_ms(cycled(library))
        out["library_device_ms"] = device_ms(cycled(library))
        out["library_host_ms"] = host_ms(cycled(library))
        out["host_over_library_host"] = out["host_ms"] / out["library_host_ms"]
    return out


def grid_of(torch, locs, H, W):
    """Pixel (y, x) locations -> grid_sample's (x, y) grid in [-1, 1]
    (align_corners=True), (B, H, W, 2)."""
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=locs.device)
    return (locs.flip(-1) * scale - 1.0).reshape(locs.shape[0], H, W, 2)


def warp_fwd_phase(torch, dev):
    """tps_warp_fwd at the inference shapes: B = 24 (a padded volume),
    192x192, C = 8 anatomy channels, bf16 and f32; and at the training
    shape, B = 12 (both fusion directions of batch 6), f32."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_fwd

    H, W, C = 192, 192, 8
    r = np.random.RandomState(0)
    cp = tps.control_grid((5, 5), dev)

    def library(v, grid):
        return F.grid_sample(v.permute(0, 3, 1, 2), grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    def timed(vol, off):
        # bound: each input read once, the output written once; operations
        # per point: 25 RBF terms of ~13 (a logf counted as one) + ~20 for
        # the affine term and corner weights + 8 per channel for the blend
        wv = tps.tps_coefficients(off)
        grid = grid_of(torch, tps.tps_sample_locations(off, (H, W)), H, W).to(vol.dtype)
        nbytes = vol.numel() * vol.element_size()
        out = measure(rotating(lambda: vol.clone(), nbytes),
                      lambda v: tps_warp_fwd(v, wv, cp), lambda v: tps._tps_warp_plain(v, off),
                      lambda v: library(v, grid),
                      2 * nbytes + wv.numel() * 4 + cp.numel() * 4,
                      vol.shape[0] * H * W * (25 * 13 + 20 + 8 * C))
        out["library_max_abs_diff"] = (library(vol, grid).permute(0, 2, 3, 1).float()
                                       - tps_warp_fwd(vol, wv, cp).float()).abs().max().item()
        return out

    B = 24
    vol32 = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
    cases = {
        "small": (r.rand(B, 25, 2) - 0.5) * 0.05,
        # larger: ~2.6% of the points fall fully outside. Much larger
        # offsets mean larger coefficients, and then the plain version's
        # expanded-form distances (kept for parity with the JAX package)
        # lose more than 2e-4 to f32 cancellation
        "large": (r.rand(B, 25, 2) - 0.5) * 0.08,
        "zero": np.zeros((B, 25, 2)),
    }
    cases = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in cases.items()}
    res = {}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).replace("torch.", "")
        vol = vol32.to(dtype)
        errs, cover = {}, {}
        for case, off in cases.items():
            got = tps_warp_fwd(vol, tps.tps_coefficients(off), cp)
            ref = tps._tps_warp_plain(vol, off)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), "non-finite warp (%s)" % case)
            errs[case] = (got.float() - ref.float()).abs().max().item()
            check(errs[case] <= tol, "tps_warp_fwd %s %s error %.3g > %g"
                  % (name, case, errs[case], tol))
            outside = (ref == 0).all(-1).float().mean().item()
            coef = tps.tps_coefficients(off).abs().max().item()
            cover[case] = {"outside_share": outside, "coef_absmax": coef}
            if case == "large":
                check(outside > 0, "no point fell outside")
        res[name] = {"max_abs_err": max(errs.values()), "errors": errs, "cases": cover,
                     **timed(vol, cases["small"])}

    # the training shape: B = 12, f32, offsets like a trained LocNet's
    B = 12
    vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
    off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * 0.05).astype(np.float32)).to(dev)
    err = (tps_warp_fwd(vol, tps.tps_coefficients(off), cp)
           - tps._tps_warp_plain(vol, off)).abs().max().item()
    check(err <= 2e-4, "tps_warp_fwd training shape error %.3g > 2e-4" % err)
    res["train_float32"] = {"shape": [B, H, W, C], "max_abs_err": err, **timed(vol, off)}
    return res


def bwd_cases(torch, r, B, H, W, dev):
    """{case: (B, H*W, 2) f32 locations} for the warp backward:
      small, large, zero  TPS locations from offsets of +-0.025, +-0.04, 0;
      scattered           uniform over [-2, H+1) x [-2, W+1): no tile's
                          corners fit a shared-memory window, and some
                          points fall outside the image;
      window_edge         y = i + 0.3, x = 2.7 j + 0.6: a tile's corner box
                          is 9 x ~88 pixels, just over a C = 8 window, so
                          part of each tile goes to global atomics; the
                          right columns fall outside the image;
      border              the small case with every 7th y and every 5th
                          x moved onto an edge row or column of the image
                          or just outside it ({-1, -0.5, 0, H-1, H-0.5}
                          and W's) or far out (the plain version has no
                          answer for NaN: the card's tests hold the
                          kernel's NaN points at 0)."""
    import numpy as np

    from multimodal_segmentation_torch.ops import tps

    out = {}
    for case, scale in (("small", 0.05), ("large", 0.08), ("zero", 0.0)):
        off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)).to(dev)
        out[case] = tps.tps_sample_locations(off, (H, W))
    lo, hi = np.array([-2.0, -2.0]), np.array([H + 1.0, W + 1.0])
    out["scattered"] = torch.from_numpy(
        (lo + r.rand(B, H * W, 2) * (hi - lo)).astype(np.float32)).to(dev)
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    edge = np.stack([i + 0.3, 2.7 * j + 0.6], -1).reshape(1, H * W, 2)
    out["window_edge"] = torch.from_numpy(np.repeat(edge, B, 0).astype(np.float32)).to(dev)
    ys = np.array([-1.0, -0.5, 0.0, H - 1.0, H - 0.5, 1e30])
    xs = np.array([-1.0, -0.5, 0.0, W - 1.0, W - 0.5, -1e30])
    border = out["small"].cpu().numpy().copy()
    border[:, ::7, 0] = r.choice(ys, border[:, ::7, 0].shape)
    border[:, ::5, 1] = r.choice(xs, border[:, ::5, 1].shape)
    out["border"] = torch.from_numpy(border.astype(np.float32)).to(dev)
    return out


def warp_bwd_phase(torch, dev):
    """tps_warp_bwd at the training shape: B = 12 (both fusion directions
    of batch 6), 192x192, C = 8 anatomy channels, f32 (and bf16), on the
    cases of bwd_cases, with g contiguous and, as the fuser hands it over,
    channels-first (a permuted view, read through its strides). Both
    versions get the same locations, so no floor() can flip. Timed at the
    small case with a contiguous g (as before), with the fuser's g, and
    at the scattered case."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_bwd as bwd

    B, H, W, C = 12, 192, 192, 8
    r = np.random.RandomState(1)
    vol32 = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
    g32 = torch.from_numpy(r.randn(B, H, W, C).astype(np.float32)).to(dev)
    cases = bwd_cases(torch, r, B, H, W, dev)
    # the fuser's g: an NCHW tensor seen through permute(0, 2, 3, 1)
    g_first = g32.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        vol, g = vol32.to(dtype), g32.to(dtype)
        gf = g_first.to(dtype)
        errs, cover = {}, {}
        for case, locs in cases.items():
            rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
            for layout, gg in (("", g), ("_g_channels_first", gf)):
                gv, gl = bwd(vol, locs, gg)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(gv.float()).all() and torch.isfinite(gl).all()),
                      "non-finite warp gradient (%s%s)" % (case, layout))
                e_vol = (gv.float() - rv.float()).abs().max().item()
                e_loc = (gl - rl).abs().max().item()
                vmax, lmax = rv.float().abs().max().item(), rl.abs().max().item()
                if dtype == torch.float32:
                    excess = ((gl - rl).abs() - 1e-4 * rl.abs()).max().item()
                    check(excess <= 5e-5, "tps_warp_bwd %s%s grad_locs error beyond 5e-5 + "
                          "1e-4 rel: %.3g" % (case, layout, excess))
                    check(e_vol <= 1e-5 * vmax, "tps_warp_bwd %s%s grad_vol error %.3g > "
                          "1e-5 x %.3g" % (case, layout, e_vol, vmax))
                else:
                    check(e_vol <= 3e-2 and e_loc <= 3e-2 * max(lmax, 1e-6),
                          "tps_warp_bwd bf16 %s%s errors %.3g, %.3g"
                          % (case, layout, e_vol, e_loc / max(lmax, 1e-6)))
                errs[case + layout] = {"grad_vol": e_vol, "grad_vol_max": vmax,
                                       "grad_locs": e_loc, "grad_locs_max": lmax}
            y, x = locs[..., 0], locs[..., 1]
            cover[case] = {"outside_share": float(
                (~((y >= -1) & (y < H) & (x >= -1) & (x < W))).float().mean())}
        # run-to-run: f32 atomics add in another order each run
        locs = cases["small"]
        a, b = bwd(vol, locs, g)[0], bwd(vol, locs, g)[0]
        rerun = (a.float() - b.float()).abs().max().item()

        # the library yardstick: grid_sample's backward alone, one retained
        # graph per rotating buffer
        nbytes = vol.numel() * vol.element_size()

        def timed(locs, layout):
            grid = grid_of(torch, locs, H, W).to(dtype)
            bufs = []
            for v, gg in rotating(lambda: (vol.clone(), g.clone()), 2 * nbytes):
                vv = v.permute(0, 3, 1, 2).detach().requires_grad_(True)
                gr = grid.detach().requires_grad_(True)
                out = F.grid_sample(vv, gr, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
                gk = gg.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) if layout else gg
                bufs.append((v, gk, (out, vv, gr, gg.permute(0, 3, 1, 2))))

            def library(buf):
                out, vv, gr, gg = buf[2]
                torch.autograd.grad(out, (vv, gr), gg, retain_graph=True)

            # bound: vol, g and locs read once, grad_vol and grad_locs
            # written once; operations per point and channel: 4 weighted
            # scatters and the two location terms (~16), per point ~20 for
            # the weights
            return measure(bufs, lambda b: bwd(b[0], locs, b[1]),
                           lambda b: tps._tps_warp_bwd_plain(b[0], locs, b[1]), library,
                           3 * nbytes + 2 * locs.numel() * 4, B * H * W * (16 * C + 20))

        res[name] = {
            "max_abs_err": max(e["grad_vol"] for e in errs.values()),
            "max_abs_err_locs": max(e["grad_locs"] for e in errs.values()),
            "errors": errs, "cases": cover, "rerun_grad_vol_diff": rerun,
            **timed(cases["small"], ""),
        }
        if dtype == torch.float32:
            res[name]["g_channels_first"] = timed(cases["small"], "channels_first")
            res[name]["scattered"] = timed(cases["scattered"], "")
    return res


# the training step's rotation groups (train/steps.py): per array its
# channels, in the order random_rotate_batch gets them
ROTATION_GROUPS = (("x1", 1), ("x2", 1), ("m1", 4), ("m2", 4)), \
    (("dm1", 4), ("dm2", 4)), (("dx1", 1), ("dx2", 1))
ROTATION_ANGLES_DEG = (0.0, 20.0, -20.0, 7.3, -13.9, 19.99)


def tie_angles(torch, dev, n):
    """n f32 angles whose sin or cos on `dev` is exactly +-0.5 (the f32
    neighbours of +-30 and +-60 degrees): on an odd-sized image they put
    locations on exact .5 ties."""
    import numpy as np

    found = []
    for deg in (30.0, -30.0, 60.0, -60.0):
        t = np.float32(np.radians(deg))
        cand = (np.array([t]).view(np.int32) + np.arange(-256, 257, dtype=np.int32)).view(np.float32)
        tt = torch.from_numpy(cand).to(dev)
        hit = ((torch.sin(tt).abs() == 0.5) | (torch.cos(tt).abs() == 0.5)).cpu().numpy()
        found += [float(a) for a in cand[hit][:1]]
    check(len(found) >= 2, "no f32 angle with an exact sin or cos of 0.5")
    return torch.tensor((found * n)[:n], dtype=torch.float32, device=dev)


def _group_arrays(torch, r, B, H, W, group, masks, dtype, dev):
    import numpy as np

    def one(c):
        x = (r.rand(B, H, W, c) > 0.7) if masks else (r.rand(B, H, W, c) * 2 - 1)
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    return [one(c) for _, c in group]


def _rotation_reference(torch, arrays, thetas):
    """The rotation as the JAX package and the CPU path compute it: the
    group concatenated, sampled at rotation_locations by the plain gather,
    split."""
    from multimodal_segmentation_torch.ops import augment

    B, H, W, _ = arrays[0].shape
    out = augment._nearest_warp_plain(torch.cat(arrays, -1),
                                      augment.rotation_locations(thetas, H, W))
    return list(torch.split(out, [a.shape[-1] for a in arrays], -1))


def rotation_phase(torch, dev):
    """The training step's rotation path: its three groups
    (ROTATION_GROUPS: 1+1+4+4, 4+4 and 1+1 channels) at B = 6, 192x192.

    Checks: rotate_group and random_rotate_batch bit-exact against the group
    concatenated, sampled at rotation_locations by the plain gather and
    split, and against the kernel's own plain version, for f32 and bf16
    images and {0,1} masks, at +-20 degrees and between, and at angles with
    exact .5 ties on an odd-sized (33x33) image.

    Timed, a step's three groups a call: `kernel` the three rotate_group
    launches (cos/sin made beforehand), `path` the three
    random_rotate_batch calls from the angles, all they launch included;
    each with its device time, host time and `wall_ms`, the host clock
    around the three calls and a synchronize (median of 50). Plain: the
    reference above; library: grid_sample nearest on each group
    concatenated beforehand."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import augment
    from multimodal_segmentation_torch.ops import cuda_kernels as ck

    B, H, W = 6, 192, 192
    r = np.random.RandomState(4)
    th = torch.from_numpy(np.radians(np.array(ROTATION_ANGLES_DEG, np.float32))).to(dev)
    res = {}
    checked, err = 0, 0.0
    for (b, h, w, angles) in ((B, H, W, th), (4, 33, 33, tie_angles(torch, dev, 4))):
        cos_t, sin_t = torch.cos(angles), torch.sin(angles)
        if h == 33:
            ly = augment.rotation_locations(angles, h, w)
            res["tie_locations"] = int(((ly - ly.floor()) == 0.5).sum())
            check(res["tie_locations"] > 0, "the tie angles gave no .5 location")
        for group in ROTATION_GROUPS:
            for dtype in (torch.float32, torch.bfloat16):
                for masks in (False, True):
                    arrays = _group_arrays(torch, r, b, h, w, group, masks, dtype, dev)
                    ref = _rotation_reference(torch, arrays, angles)
                    for got in (ck.rotate_group(arrays, cos_t, sin_t),
                                augment.random_rotate_batch(arrays, angles),
                                augment._rotate_group_plain(arrays, cos_t, sin_t)):
                        torch.cuda.synchronize()
                        err = max([err] + [(x.float() - y.float()).abs().max().item()
                                           for x, y in zip(got, ref)])
                        check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                              "rotate_group %s differs (%dx%d, %s, masks=%s)"
                              % ([n for n, _ in group], h, w, dtype, masks))
                    checked += 1
    res.update(bit_exact=True, groups_checked=checked, max_abs_err=err)

    groups = [_group_arrays(torch, r, B, H, W, g, False, torch.float32, dev)
              for g in ROTATION_GROUPS]
    nbytes = sum(a.numel() * 4 for grp in groups for a in grp)
    bufs = rotating(lambda: [[a.clone() for a in grp] for grp in groups], nbytes)
    grid = grid_of(torch, augment.rotation_locations(th, H, W), H, W)
    cat = [[torch.cat(grp, -1).permute(0, 3, 1, 2) for grp in buf] for buf in bufs]
    cats = {id(buf): c for buf, c in zip(bufs, cat)}
    cos_t, sin_t = torch.cos(th), torch.sin(th)

    def library(buf):
        for c in cats[id(buf)]:
            F.grid_sample(c, grid, mode="nearest", padding_mode="border", align_corners=True)

    def plain(buf):
        for grp in buf:
            _rotation_reference(torch, grp, th)

    def path(buf):
        for grp in buf:
            augment.random_rotate_batch(grp, th)

    def wall(fn, iters=50):
        it = itertools.cycle(bufs)
        fn(next(it))
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(next(it))
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return sorted(ts)[len(ts) // 2]

    # bound: each array read once and each output written once; ~26
    # operations a point and group (the location, round, clamp, index)
    work = (2 * nbytes, 3 * B * H * W * 26)
    def kernel(buf):
        for grp in buf:
            ck.rotate_group(grp, cos_t, sin_t)

    res["path"] = {**measure(bufs, path, plain, library, *work, plain_iters=10),
                   "wall_ms": wall(path)}
    res["kernel"] = {**measure(bufs, kernel, lambda buf: [
        augment._rotate_group_plain(grp, cos_t, sin_t) for grp in buf], library, *work,
        plain_iters=10), "wall_ms": wall(kernel), "max_abs_err": err}
    res["plain_wall_ms"] = wall(plain)
    return res


def round_ste_phase(torch, dev):
    """round_ste against torch.round (the plain version, and also the
    library call), bit for bit: values with exact .5 ties in f32 and bf16,
    at the training shape (12, 8, 192, 192: both modalities' anatomies of
    batch 6), the inference shape (38, 8, 192, 192: a 19-slice volume's two
    modalities) and a size that is a multiple neither of 128 nor of a
    block, from an aligned and from an unaligned start. Timed at both
    shapes in f32."""
    import numpy as np

    from multimodal_segmentation_torch.ops.cuda_kernels import round_ste

    r = np.random.RandomState(3)
    shapes = {"train": (12, 8, 192, 192), "inference": (38, 8, 192, 192), "odd": (1000003,)}
    res, err = {}, 0.0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        x = (r.rand(n + 1) * 8 - 4).astype(np.float32)
        x[::4] = np.floor(x[::4]) + 0.5   # exact ties
        x[:4] = [0.5, 1.5, 2.5, -0.5]
        x32 = torch.from_numpy(x).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xt = x32.to(dtype)
            for view in (xt[:n].reshape(shape), xt[1:].reshape(shape)):
                got, ref = round_ste(view.contiguous()), torch.round(view)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), "round_ste %s %s differs from torch.round"
                      % (name, dtype))
                err = max(err, (got.float() - ref.float()).abs().max().item())
        check(torch.equal(round_ste(x32[:4]).cpu(), torch.tensor([0.0, 2.0, 2.0, -0.0])),
              "round_ste ties")
        if name == "odd":
            continue
        # anatomy-like values in [0, 1]; bound: read once, written once,
        # one operation an element
        vol = torch.from_numpy(r.rand(*shape).astype(np.float32)).to(dev)
        nbytes = vol.numel() * 4
        res[name + "_float32"] = {
            "shape": list(shape), "max_abs_err": err, "bit_exact": True,
            **measure(rotating(lambda: vol.clone(), nbytes), round_ste, torch.round,
                      torch.round, 2 * nbytes, vol.numel(), plain_iters=60),
        }
    return res


def launch_path_phase(torch, dev):
    """Host us a call of each part of a wrapper's launch path, on
    round_ste at the training shape (12, 8, 192, 192) f32: the
    current-device test, the raw stream handle, the TORCH_LIBRARY operator
    that checks, allocates and launches (`entry`), the whole wrapper, and
    torch.round for comparison, called directly and through torch.ops.
    Parts that launch are timed as host_ms times them (200 calls, no
    wait); the others over 20,000 calls."""
    from multimodal_segmentation_torch.ops import cuda_kernels as ck

    x = torch.rand(12, 8, 192, 192, device=dev)
    idx = dev.index
    fn = ck.ROUND_STE.fn()
    stream = torch._C._cuda_getCurrentRawStream(idx)

    def us(f, iters=20000):
        t = time.perf_counter()
        for _ in range(iters):
            f()
        return 1e6 * (time.perf_counter() - t) / iters

    parts = {
        "current_device_test": us(lambda: x.get_device() == torch._C._cuda_getDevice()),
        "raw_stream": us(lambda: torch._C._cuda_getCurrentRawStream(idx)),
        "entry": 1e3 * host_ms(lambda: fn(x, stream)),
        "wrapper": 1e3 * host_ms(lambda: ck.round_ste(x)),
        "torch_round": 1e3 * host_ms(lambda: torch.round(x)),
        # the same operator through torch.ops, the way an operator
        # registered with TORCH_LIBRARY is called from Python
        "torch_ops_round": 1e3 * host_ms(lambda: torch.ops.aten.round.default(x)),
    }
    return {"shape": list(x.shape), "host_us": parts}


def flow_phase(torch, dev):
    """tps_flow_dbg (B5) against its plain version at the tool's shape (B =
    2) and at B1's (B = 12, training; B = 24, inference), 192x192, offsets
    of +-0.025: flow within 2e-4 px, qy, qx and phi_0 within 1e-6. At B =
    12 and 24 the stages check: B1 on f32 images in [0, 1] against the
    plain bilinear blend at B5's locations, within 1e-5 (a flow that
    differed at all would flip floor() at pixel edges). At each B the gap
    between B5's locations and tps_sample_locations, which the warp's
    backward recomputes (reported, not held). Timed at B = 12 and 24 (at B
    = 2 a time measures the launch); the outputs of the last calls are kept,
    so that each call writes memory the previous ones did not. No PyTorch
    call computes this function: no library time."""
    import collections

    import numpy as np

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_flow_dbg, tps_warp_fwd
    from multimodal_segmentation_torch.ops.resample import bilinear_sample

    H, W, C = 192, 192, 8
    r = np.random.RandomState(5)
    cp = tps.control_grid((5, 5), dev)
    res = {}
    for B in (2, 12, 24):
        off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * 0.05).astype(np.float32)).to(dev)
        wv = tps.tps_coefficients(off)
        got = tps_flow_dbg(wv, cp, (H, W))
        ref = tps._tps_flow_stage_plain(wv, cp, (H, W))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "non-finite flow at B=%d" % B)
        err = (got - ref).abs().amax((0, 1)).tolist()
        check(max(err[:2]) <= 2e-4 and max(err[2:]) <= 1e-6,
              "tps_flow_dbg B=%d errors %s (flow px, qy, qx, phi_0)" % (B, err))
        locs = got[..., :2].contiguous()
        out = {
            "shape": [B, H, W],
            "errors": dict(zip(("flow_y_px", "flow_x_px", "qy", "qx", "phi0"), err)),
            "max_abs_err": max(err),
            "location_gap_px": (locs - tps.tps_sample_locations(off, (H, W))).abs().max().item(),
        }
        if B > 2:
            vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
            stages = (tps_warp_fwd(vol, wv, cp)
                      - bilinear_sample(vol, locs).reshape(B, H, W, C)).abs().max().item()
            check(stages <= 1e-5, "B1 against a blend at B5's locations, B=%d: %.3g > 1e-5"
                  % (B, stages))
            # bound: the output written once, the coefficients and control
            # points read once; per point 25 RBF terms of ~13 operations (a
            # logf counted as one) and ~10 for the affine term and scaling
            nbytes = got.numel() * 4
            bufs = rotating(lambda: wv.clone(), nbytes)
            keep = collections.deque(maxlen=len(bufs))
            out["stages_max_abs_diff"] = stages
            out.update(measure(bufs, lambda w: keep.append(tps_flow_dbg(w, cp, (H, W))),
                               lambda w: tps._tps_flow_stage_plain(w, cp, (H, W)), None,
                               nbytes + wv.numel() * 4 + cp.numel() * 4,
                               B * H * W * (25 * 13 + 10)))
            keep.clear()
        res["B=%d" % B] = out
    return res


def debug_warp_phase(torch, device):
    """The warp-bisect tool's main on `device` (its prints captured): its
    five max differences, held at 1e-3 px for the flow against
    tps_sample_locations and 1e-6 for qy, qx and phi_0, and the kernel
    launches of the run: on the card one tps_flow_dbg and nothing else."""
    import contextlib
    import io

    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.tools import debug_warp_kernel

    printed = io.StringIO()
    cuda_kernels.reset_launch_counts()
    with contextlib.redirect_stdout(printed):
        diffs = debug_warp_kernel.main(["--device", device])
    launches = cuda_kernels.launch_counts()
    check(all(math.isfinite(v) for v in diffs.values()), "non-finite bisect: %s" % diffs)
    check(max(diffs["flow_y"], diffs["flow_x"]) <= 1e-3
          and max(diffs["qy"], diffs["qx"], diffs["phi0"]) <= 1e-6, "bisect diffs %s" % diffs)
    if device == "cuda":
        want = dict.fromkeys(launches, 0)
        want["tps_flow_dbg"] = 1
        check(launches == want, "debug-warp launches %s != %s" % (launches, want))
    return {"device": device, "diffs": diffs, "printed": printed.getvalue().splitlines(),
            "launches": launches}


def _seed_weights(torch, model, seed):
    """The seeded changes named at ANATOMY_GAIN / DENSE1_STD."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.enc_anatomy.conv_anatomy.weight.mul_(ANATOMY_GAIN)
        d1 = model.fuser.locnet.Dense_1
        d1.weight.copy_(torch.randn(d1.weight.shape, generator=g) * DENSE1_STD)
        d1.bias.copy_(torch.randn(d1.bias.shape, generator=g) * DENSE1_STD)


def _mean_dice(folder):
    with open(os.path.join(folder, "results.csv")) as f:
        rows = list(csv.reader(f, skipinitialspace=True))[1:]
    return sum(float(r[1]) for r in rows) / len(rows), len(rows)


def slice_phase(torch, conf, device):
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.eval import ModelTester
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels

    on_card = device == "cuda"
    model = build_model(conf, device=device)
    _seed_weights(torch, model, conf.seed)
    tester = ModelTester(model, conf, device=device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # warm-up volume (cuDNN plans, the kernel's first launch), not counted
    loader = init_loader(conf.test_dataset)
    data = loader.load_all_modalities_concatenated(conf.split, "test")
    data.crop(conf.input_hw)
    v0 = data.volumes()[0]
    warm = [data.get_volume_images_modi(i, v0) for i in (0, 1)]
    for ftype in ("simple", "def", "max"):
        model.predict_mask(1, ftype, warm, device=device)
    sync()

    times = {}
    predict = model.predict_mask

    def timed(modality_index, fusion_type, images, device):
        sync()
        t0 = time.perf_counter()
        out = predict(modality_index, fusion_type, images, device=device)
        sync()
        times.setdefault(fusion_type, []).append(time.perf_counter() - t0)
        check(out.shape == (images[0].shape[0],) + tuple(conf.input_hw) + (conf.num_masks + 1,),
              "predict_mask shape %s" % (tuple(out.shape),))
        check(bool(torch.isfinite(out).all()), "non-finite masks")
        check((out.sum(-1) - 1).abs().max().item() < 1e-4, "masks do not sum to 1")
        return out

    model.predict_mask = timed
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    tester.test_modality("t2", 1)
    launches = cuda_kernels.launch_counts()
    del model.predict_mask

    # what the anatomy and the warp did on one volume (outside the counts)
    xs = [torch.as_tensor(w, device=device).permute(0, 3, 1, 2) for w in warm]
    with torch.inference_mode():
        s2, s1 = model.enc_anatomy(xs[1], xs[0])
        theta = model.fuser.locnet(s1, s2)
        s1_def, _ = model.fuser(s1, s2, fast=True)
    theta = theta.abs()

    dice = {}
    for suffix in ("", "_rand"):
        for ftype in ("simple", "def", "max"):
            folder = os.path.join(conf.folder, "test_results_%s_t2_%s%s"
                                  % (conf.test_dataset, ftype, suffix))
            mean, n = _mean_dice(folder)
            check(0.0 <= mean <= 1.0 and n == len(data.volumes()), "Dice %s" % folder)
            dice[ftype + suffix] = mean
    calls = len(times["def"]) + len(times["max"])
    if on_card:
        check(launches["tps_warp_fwd"] == calls > 0,
              "tps_warp_fwd launches %d != def/max calls %d"
              % (launches["tps_warp_fwd"], calls))
        check(launches["round_ste"] == sum(len(v) for v in times.values()),
              "round_ste launches %d != predict_mask calls" % launches["round_ste"])
    p50 = {k: 1e3 * sorted(v)[len(v) // 2] for k, v in times.items()}
    out = {
        "config": "dafnet_chaos" if conf.input_hw == (192, 192) else "tiny",
        "device": str(device),
        "volumes": data.volumes(),
        "slices": [int(data.get_volume_images_modi(0, v).shape[0]) for v in data.volumes()],
        "mean_dice": dice,
        "p50_ms_per_volume": p50,
        "ms_per_volume": {k: [1e3 * t for t in v] for k, v in times.items()},
        "predict_calls": {k: len(v) for k, v in times.items()},
        "launches": launches,
        "anatomy_nonzero_share": float((s1 > 0).any(1).float().mean()),
        "offsets_abs_mean": float(theta.mean()),
        "offsets_abs_max": float(theta.max()),
        "warp_changed_anatomy": float((s1_def - s1).abs().max()),
    }
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return model, warm, out


def cross_device_phase(torch, conf, model, warm, device):
    """predict_mask(1, 'max') on two slices on `device` and on the CPU."""
    from multimodal_segmentation_torch.models import build_model

    x = [w[:2] for w in warm]
    m_dev = model.predict_mask(1, "max", x, device=device).float().cpu()
    cpu_model = build_model(conf, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    m_cpu = cpu_model.predict_mask(1, "max", x, device="cpu")
    agree = m_dev.argmax(-1) == m_cpu.argmax(-1)
    share = 1.0 - agree.float().mean().item()
    diff = (m_dev - m_cpu).abs().amax(-1)[agree].max().item()
    check(share <= 1e-3, "argmax differs on %.3g of pixels (> 1e-3)" % share)
    return {"argmax_differ_share": share, "max_abs_prob_diff_agreeing": diff,
            "pixels": int(agree.numel())}


def _train_setup(torch, conf, device):
    """(model, train state, step_supervised, expert batch iterator) at
    `conf`, with the slice's seeded weights."""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.data.batches import expert_batches
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state

    loader = init_loader("synthetic", hw=conf.input_hw)
    loader.modalities = list(conf.modality)
    model = build_model(conf, device=device)
    _seed_weights(torch, model, conf.seed)
    return (model, create_train_state(model, conf), DAFNetSteps(model, conf).step_supervised,
            expert_batches(conf, loader))


def train_phase(torch, conf, device, warmup, steps):
    """step_supervised on expert batches from the synthetic loader's
    training split, as the JAX package's DAFNetExecutor assembles them."""
    from multimodal_segmentation_torch.ops import cuda_kernels

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model, ts, steps_fn, batches = _train_setup(torch, conf, device)
    names = model.GEN_COMPONENTS + model.DISC_COMPONENTS
    before = {n: [p.detach().clone() for p in getattr(model, n).parameters()] for n in names}
    setup_s = time.perf_counter() - t0

    metrics, times = [], []
    for i in range(warmup + steps):
        batch = next(batches)
        if i == warmup:
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launch_counts()
        sync()
        t = time.perf_counter()
        ts, m = steps_fn(ts, batch)
        sync()
        dt = time.perf_counter() - t
        m = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in m.values()), "non-finite metric at step %d: %s" % (i, m))
        metrics.append(m)
        if i >= warmup:
            times.append(dt)
    launches = cuda_kernels.launch_counts()
    if on_card:
        want = {"tps_warp_fwd": 2 * steps, "tps_warp_bwd": steps, "nearest_warp": 3 * steps,
                "round_ste": 2 * steps, "tps_flow_dbg": 0}
        check(launches == want, "train launches %s != %s" % (launches, want))
    moved = {n: max((p.detach() - b).abs().max().item()
                    for p, b in zip(getattr(model, n).parameters(), before[n])) for n in names}
    check(all(moved[n] > 0 for n in names if n != "balancer"), "a component did not move: %s" % moved)
    check(moved["balancer"] == 0.0, "the balancer moved: %g" % moved["balancer"])
    ms = sorted(1e3 * t for t in times)
    p50 = ms[len(ms) // 2]
    out = {
        "config": "dafnet_chaos" if conf.input_hw == (192, 192) else "tiny",
        "device": str(device),
        "batch": conf.batch_size,
        "input": list(conf.input_shape),
        "compute_dtype": conf.compute_dtype,
        "setup_s": setup_s,
        "warmup_steps": warmup,
        "timed_steps": steps,
        "metrics": metrics,
        "ms_per_step": [1e3 * t for t in times],
        "p50_ms_per_step": p50,
        "ms_per_step_range": [ms[0], ms[-1]],
        "slices_per_s": conf.batch_size / (p50 / 1e3),
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "max_param_change": moved,
    }
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def train_cross_device_phase(torch, device):
    """One step_supervised at the tiny config on `device` and on the CPU,
    from the same weights, batch and noise.

    Limits: 1e-3 relative for the generator's metrics, computed before any
    update. The discriminator metrics see the fake pools of the updated
    generator, where a gradient component near 0 may give its Adam step
    either sign on either device: above all the conv biases ahead of a
    BatchNorm, whose gradient is 0 in exact arithmetic and roundoff on
    either device. In eval mode those biases move the anatomy by ~1e-4,
    and an anatomy value that close to 0.5 rounds the other way, which
    moves a discriminator loss by up to ~1e-2 (3.3e-3 measured on the
    H100). Limit 2e-2. The anatomy head is sharpened (x20) against ties
    from the forward's own roundoff; the smallest distance from 0.5 on the
    CPU is printed."""
    from multimodal_segmentation_torch import config
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state, draw_noise

    conf = config.tiny_test_config()
    model, _, _, batches = _train_setup(torch, conf, device)
    batch = next(batches)
    noise = draw_noise(torch.Generator().manual_seed(conf.seed), conf.batch_size,
                       conf.num_z, conf.rotation_range)
    with torch.no_grad():
        model.enc_anatomy.conv_anatomy.weight.mul_(20.0)
    cpu_model = build_model(conf, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    seen = []
    cpu_model.enc_anatomy.conv_anatomy.register_forward_hook(
        lambda m, i, o: seen.append(float((torch.softmax(o.detach().float(), 1) - 0.5).abs().min())))
    out = {}
    for name, m in (("device", model), ("cpu", cpu_model)):
        _, met = DAFNetSteps(m, conf).step_supervised(create_train_state(m, conf), batch, noise)
        out[name] = {k: float(v) for k, v in met.items()}
    rel = {k: abs(out["device"][k] / out["cpu"][k] - 1.0) for k in out["cpu"]}
    for k, v in rel.items():
        lim = 2e-2 if k.startswith("dis_") else 1e-3
        check(v <= lim, "train cross-device %s differs by %.3g (> %g)" % (k, v, lim))
    return {"config": "tiny", "device": str(device), "rel_diff": rel,
            "max_rel_diff_generator": max(v for k, v in rel.items() if not k.startswith("dis_")),
            "max_rel_diff_discriminators": max(v for k, v in rel.items() if k.startswith("dis_")),
            "metrics": out, "min_anatomy_distance_from_half": min(seen)}


def experiment_phase(torch, device, preset):
    """The training executor through the CLI's own config: build_config of
    `--config <preset> --split 0 --l_mix 0.5` on the synthetic data, so that
    both step_supervised and step_unsupervised run, with EXP_STEPS batches
    an epoch and SWA from epoch 1. EXP_EPOCHS epochs, then a new executor
    resumes from the checkpoint to EXP_RESUME_EPOCHS epochs, then
    `Experiment().run([..., "--test"])` tests the same folder. Everything
    runs in chip_smoke_out/experiment/, made afresh."""
    import numpy as np

    from multimodal_segmentation_torch import experiment
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.models.dafnet import DAFNet
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.train.executor import make_executor

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    flags = ["--config", preset, "--split", "0", "--l_mix", "0.5", "--dataset", "synthetic",
             "--test_dataset", "synthetic", "--device", device]
    work = os.path.join(OUT_DIR, "experiment")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # predict_mask calls, for the launch check: each runs the anatomy
    # encoder once; 'def' and 'max' warp once
    calls = {"predict": 0, "warped": 0}
    predict = DAFNet.predict_mask

    def counted(self, modality_index, fusion_type, images, device="cuda"):
        calls["predict"] += 1
        calls["warped"] += fusion_type in ("def", "max")
        return predict(self, modality_index, fusion_type, images, device=device)

    def trained(conf):
        model = build_model(conf, device=device)
        _seed_weights(torch, model, conf.seed)
        ex = make_executor(conf, model, device=device)
        ex.train()
        return ex

    cwd = os.getcwd()
    DAFNet.predict_mask = counted
    try:
        os.chdir(work)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        conf = experiment.build_config(experiment.read_console_parameters(
            flags + ["--epochs", str(EXP_EPOCHS)]))
        conf.steps_per_epoch, conf.swa_start_epoch = EXP_STEPS, 1
        first = trained(conf)
        conf.epochs = EXP_RESUME_EPOCHS
        second = trained(conf)
        ts = second.final_state
        sync()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        experiment.Experiment().run(flags + ["--test"])
        test_s = time.perf_counter() - t0
        launches = cuda_kernels.launch_counts()
        folder = os.path.join(work, conf.folder)

        seconds = {**first.epoch_seconds, **second.epoch_seconds}
        resume_start = min(second.epoch_seconds)
        check(sorted(first.epoch_seconds) == list(range(EXP_EPOCHS)) and resume_start == EXP_EPOCHS
              and sorted(seconds) == list(range(EXP_RESUME_EPOCHS)),
              "epochs run: %s, then %s" % (sorted(first.epoch_seconds), sorted(second.epoch_seconds)))
        check(first.final_state.step == EXP_EPOCHS * EXP_STEPS * 2 and ts.step == EXP_RESUME_EPOCHS
              * EXP_STEPS * 2, "steps %d, %d" % (first.final_state.step, ts.step))
        # SWA from epoch 1: the mean of the live parameters at the end of
        # epochs 1 .. EXP_RESUME_EPOCHS - 1, which those epochs' checkpoints hold
        ckpt_dir = os.path.join(folder, "checkpoints")
        ckpt_epochs = list(range(1, EXP_RESUME_EPOCHS))
        check(sorted(os.listdir(ckpt_dir)) == ["epoch_%d.pt" % e for e in ckpt_epochs],
              "checkpoints %s" % sorted(os.listdir(ckpt_dir)))
        live_sum = {}
        for e in ckpt_epochs:
            sd = torch.load(os.path.join(ckpt_dir, "epoch_%d.pt" % e), map_location=device,
                            weights_only=True)["model"]
            for n in ts.swa:
                live_sum[n] = live_sum[n] + sd[n] if n in live_sum else sd[n]
            del sd
        swa_err = 0.0
        for n, avg in ts.swa.items():
            mean = live_sum[n] / len(ckpt_epochs)
            swa_err = max(swa_err, ((avg - mean).abs().max() / mean.abs().max().clamp_min(1e-30)).item())
        del live_sum
        check(swa_err <= 1e-6, "SWA differs from the mean of the live snapshots by %.3g" % swa_err)
        with open(os.path.join(folder, "training.csv")) as f:
            rows = list(csv.DictReader(f))
        check([int(r["epoch"]) for r in rows] == list(range(EXP_RESUME_EPOCHS)),
              "training.csv epochs %s" % [r["epoch"] for r in rows])
        check(all(math.isfinite(float(v)) for r in rows for v in r.values()),
              "a logged metric is not finite")
        with open(os.path.join(folder, "test_error.txt")) as f:
            check(len(f.read().splitlines()) == EXP_RESUME_EPOCHS, "test_error.txt rows")
        steps = ts.step
        image_epochs = sum("images" in s for s in seconds.values())
        if on_card:
            # per step 2/1/3/2; predict_mask: the anatomy encoder once,
            # 'def'/'max' one warp; the image callback encodes once more
            want = {"tps_warp_fwd": 2 * steps + calls["warped"], "tps_warp_bwd": steps,
                    "nearest_warp": 3 * steps,
                    "round_ste": 2 * steps + calls["predict"] + image_epochs, "tps_flow_dbg": 0}
            check(launches == want, "experiment launches %s != %s" % (launches, want))
        dice = {}
        for mod in conf.modality:
            for suffix in ("", "_rand"):
                for ftype in ("simple", "def", "max"):
                    mean, n = _mean_dice(os.path.join(
                        folder, "test_results_synthetic_%s_%s%s" % (mod, ftype, suffix)))
                    check(0.0 <= mean <= 1.0 and n > 0, "test Dice %s %s%s" % (mod, ftype, suffix))
                    dice["%s_%s%s" % (mod, ftype, suffix)] = mean
        pngs = [os.path.join(dp, f) for dp, _, fs in os.walk(folder) for f in fs
                if f.endswith(".png")]
        artifacts = {
            "training.csv": len(rows),
            "test_error.txt": True,
            "models": sorted(os.listdir(os.path.join(folder, "models"))),
            "checkpoints": sorted(os.listdir(os.path.join(folder, "checkpoints"))),
            "results.csv": sum(f == "results.csv" for _, _, fs in os.walk(folder) for f in fs),
            "pngs": len(pngs) if pngs else "skipped: no PIL or matplotlib",
        }
        check(len(artifacts["models"]) == 9 and artifacts["results.csv"] == 12,
              "artifacts %s" % artifacts)
    finally:
        DAFNet.predict_mask = predict
        os.chdir(cwd)

    def ms(part):
        return [1e3 * seconds[e][part] for e in sorted(seconds) if part in seconds[e]]

    out = {
        "config": preset,
        "device": str(device),
        "folder": os.path.relpath(folder, REPO),
        "l_mix": conf.l_mix,
        "steps_per_epoch": EXP_STEPS,
        "epochs": [EXP_EPOCHS, EXP_RESUME_EPOCHS],
        "resume_start_epoch": resume_start,
        "steps": steps,
        "train_s": train_s,
        "test_s": test_s,
        "ms_per_epoch_training": ms("training"),
        "ms_validation": ms("validation"),
        "ms_checkpoint_save": ms("checkpoint"),
        "ms_component_export": ms("export"),
        "ms_image_callback": ms("images"),
        "checkpoint_bytes": os.path.getsize(os.path.join(ckpt_dir, "epoch_%d.pt" % ckpt_epochs[-1])),
        "launches": launches,
        "predict_mask_calls": calls,
        "validation_logs": {k: float(v) for k, v in rows[-1].items() if k.startswith("val_")},
        "training_csv_last": {k: float(v) for k, v in rows[-1].items()},
        "test_dice": dice,
        "swa_max_rel_err": swa_err,
        "artifacts": artifacts,
        "mean_test_dice": float(np.mean(list(dice.values()))),
    }
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def _kernel_kind(name):
    n = name.lower()
    if any(k in n for k in ("tps_warp_fwd", "tps_warp_bwd", "nearest_copy", "round_ste",
                            "tps_flow_dbg")):
        return "port kernels"
    # cuDNN's FFT-tiling convolutions: complex (cf32) GEMMs, FFTs, tile transforms
    if any(k in n for k in ("cf32", "fft", "dse::", "region_transform")):
        return "convolution"
    if any(k in n for k in ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")):
        return "convolution"
    if "gemm" in n or "cutlass" in n or "sm90_" in n:
        return "matmul"
    if "reduce" in n or "norm" in n:
        return "reduction"
    if "memcpy" in n or "memset" in n:
        return "copy/fill"
    return "elementwise/other"


def train_profile_phase(torch, conf, device, warmup=2, steps=3):
    """torch.profiler over `steps` step_supervised calls (after `warmup`):
    device time by kernel and by kind, and the share of the window the
    device was busy."""
    from torch.profiler import ProfilerActivity, profile

    _, ts, step, batches = _train_setup(torch, conf, device)
    for _ in range(warmup):
        ts, _ = step(ts, next(batches))
    feed = [next(batches) for _ in range(steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in feed:
            ts, _ = step(ts, batch)
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    device_us = sum(r[0] for r in rows)
    check(device_us > 0, "the profiler saw no device time")
    kinds = {}
    for us, key, _ in rows:
        kinds[_kernel_kind(key)] = kinds.get(_kernel_kind(key), 0.0) + us
    return {
        "steps": steps,
        "wall_ms_per_step": wall_us / 1e3 / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_busy_share": device_us / wall_us,
        "ms_per_step_by_kind": {k: v / 1e3 / steps for k, v in
                                sorted(kinds.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": key[:120], "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": n / steps} for us, key, n in rows[:25]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="slice, cross-device, train, debug-warp and experiment "
                         "at the tiny config on the CPU; no result line")
    ap.add_argument("--profile-train", action="store_true",
                    help="only profile full-width train steps on the card; "
                         "no result line")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "multimodal_segmentation_torch")):
        sys.exit("chip_smoke.py: the multimodal_segmentation_torch package is "
                 "not in %s; run it from the repository" % REPO)
    sys.path.insert(0, REPO)
    import torch

    from multimodal_segmentation_torch import config

    if args.cpu_rehearsal:
        conf = config.tiny_test_config()
        conf.test_dataset, conf.folder = "synthetic", os.path.join(OUT_DIR, "rehearsal")
        model, warm, res = slice_phase(torch, conf, "cpu")
        emit("slice", **res)
        emit("cross-device", **cross_device_phase(torch, conf, model, warm, "cpu"))
        emit("train", **train_phase(torch, config.tiny_test_config(), "cpu", 1, 2))
        emit("train-cross-device", **train_cross_device_phase(torch, "cpu"))
        emit("debug-warp", **debug_warp_phase(torch, "cpu"))
        config.PRESETS.setdefault("tiny", config.tiny_test_config)
        emit("experiment", **experiment_phase(torch, "cpu", "tiny"))
        return 0

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
                 "false); this script needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from multimodal_segmentation_torch.ops import cuda_kernels

    if args.profile_train:
        conf = config.dafnet_chaos()
        conf.dataset_name = "synthetic"
        emit("train-profile", card=nvidia_smi(),
             **train_profile_phase(torch, conf, "cuda"))
        return 0

    smi = nvidia_smi()
    emit("env", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    builds = cuda_kernels.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=builds)

    dev = torch.device("cuda", 0)
    kern = {
        "tps_warp_fwd": warp_fwd_phase(torch, dev),
        "tps_warp_bwd": warp_bwd_phase(torch, dev),
        "rotation": rotation_phase(torch, dev),
        "round_ste": round_ste_phase(torch, dev),
        "launch_path": launch_path_phase(torch, dev),
        "flow": flow_phase(torch, dev),
    }
    fwd = kern["tps_warp_fwd"]
    kern["flow"]["share_of_b1_device_ms"] = {
        "train B=12 f32": kern["flow"]["B=12"]["device_ms"] / fwd["train_float32"]["device_ms"],
        "infer B=24 bf16": kern["flow"]["B=24"]["device_ms"] / fwd["bfloat16"]["device_ms"],
        "infer B=24 f32": kern["flow"]["B=24"]["device_ms"] / fwd["float32"]["device_ms"],
    }
    emit("kernels", card=smi, **kern)
    bisect = debug_warp_phase(torch, "cuda")
    emit("debug-warp", **bisect)

    conf = config.dafnet_chaos()
    conf.test_dataset, conf.folder = "synthetic", os.path.join(OUT_DIR, "dafnet_chaos")
    model, warm, res = slice_phase(torch, conf, "cuda")
    emit("slice", card=smi, **res)
    emit("cross-device", **cross_device_phase(torch, conf, model, warm, "cuda"))
    del model, warm

    conf = config.dafnet_chaos()
    conf.dataset_name = "synthetic"
    train = train_phase(torch, conf, "cuda", TRAIN_WARMUP, TRAIN_STEPS)
    emit("train", card=smi, **train)
    emit("train-cross-device", **train_cross_device_phase(torch, "cuda"))
    exp = experiment_phase(torch, "cuda", "dafnet_config_chaos")
    emit("experiment", card=smi, **exp)

    # launches: the slice's (inference), the train phase's, the experiment
    # phase's and the warp-bisect tool's
    paths = {"slice": res["launches"], "train": train["launches"], "experiment": exp["launches"],
             "debug-warp": bisect["launches"]}
    launches = {k: sum(p[k] for p in paths.values()) for k in train["launches"]}
    main_dtype = "bfloat16" if conf.eval_warp == "bf16" else "float32"
    src = "multimodal_segmentation_torch/csrc/"
    pallas = "multimodal_segmentation_tpu/ops/pallas_kernels.py:"
    summary = []
    for name, source, replaces, k, work in (
            ("tps_warp_fwd", "tps_warp.cu", pallas + "315", kern["tps_warp_fwd"][main_dtype],
             "B=24 192x192 C=8 %s (inference)" % main_dtype),
            ("tps_warp_bwd", "tps_warp_bwd.cu", pallas + "269", kern["tps_warp_bwd"]["float32"],
             "B=12 192x192 C=8 float32 (training)"),
            ("nearest_warp", "nearest_warp.cu", pallas + "416", kern["rotation"]["kernel"],
             "B=6 192x192 float32, groups of 1+1+4+4, 4+4 and 1+1 channels: the 3 "
             "rotate_group launches of one training step"),
            ("round_ste", "round_ste.cu", pallas + "58", kern["round_ste"]["train_float32"],
             "(12, 8, 192, 192) float32: the anatomy of one training step's loss"),
            ("tps_flow_dbg", "tps_flow_dbg.cu", "tools/debug_warp_kernel.py:60",
             kern["flow"]["B=24"], "B=24 192x192 float32, 5 values a point: B1's flow "
             "stage at its inference shape")):
        summary.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {p: counts[name] for p, counts in paths.items()},
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "device_ms": k["device_ms"],
            "host_ms": k["host_ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "library_device_ms": k["library_device_ms"],
            "library_host_ms": k["library_host_ms"],
            "work": work,
        })
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
