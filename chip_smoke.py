#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (multimodal_segmentation_torch) on one GPU and
check what comes out.

Phases, one JSON line each:
  env           the card's name and count, nvidia-smi's name and power
                limit, torch and CUDA versions, both TF32 flags
  build         every CUDA kernel built from csrc/ (one nvcc per source, all
                started together): seconds, ptxas register/spill lines
  kernels       each kernel at the main path's shapes against its plain
                PyTorch version: max abs error, time, bound, plain and
                library times (tps_warp_fwd, tps_warp_bwd, nearest_warp)
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
                ms per step and slices/s, kernel launches per step, peak
                device memory, which parameters moved
  train-cross-device
                one step_supervised at the tiny config on the card and on
                the CPU, same weights, batch and noise: relative difference
                of each metric

Then nvidia-smi's name/power line, the kernels summary and, last, the result
line. Any failed check raises, and the script exits non-zero without a
result line; so it does without a CUDA device, or outside the repository.

  python3 chip_smoke.py                  # needs one CUDA device
  python3 chip_smoke.py --cpu-rehearsal  # slice, cross-device and train at
                                         # the tiny config on the CPU with the
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


def rotating(tensors_fn, nbytes, floor=160 * 2 ** 20):
    """Enough copies of the inputs that consecutive calls miss the 50 MB L2."""
    return [tensors_fn() for _ in range(max(2, -(-floor // nbytes)))]


def measure(bufs, kernel, plain, library, moved, flops, plain_iters=10):
    """Time kernel(buf), plain(buf) and library(buf), each call on the next
    of the rotating buffers `bufs`, and the bound of the work: the larger of
    `moved` bytes over the HBM rate and `flops` over the f32 rate."""
    def cycled(fn):
        it = itertools.cycle(bufs)
        return lambda: fn(next(it))

    ms, ms_spread = time_ms(cycled(kernel))
    plain_ms, plain_spread = time_ms(cycled(plain), iters=plain_iters)
    library_ms, library_spread = time_ms(cycled(library))
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {
        "ms": ms, "ms_spread": ms_spread,
        "plain_ms": plain_ms, "plain_ms_spread": plain_spread,
        "library_ms": library_ms, "library_ms_spread": library_spread,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved, "flops": flops,
    }


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


def warp_bwd_phase(torch, dev):
    """tps_warp_bwd at the training shape: B = 12 (both fusion directions
    of batch 6), 192x192, C = 8 anatomy channels, f32 (and bf16). Both
    versions get the same locations, so no floor() can flip."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_bwd

    B, H, W, C = 12, 192, 192, 8
    r = np.random.RandomState(1)
    vol32 = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
    g32 = torch.from_numpy(r.randn(B, H, W, C).astype(np.float32)).to(dev)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        vol, g = vol32.to(dtype), g32.to(dtype)
        errs, cover = {}, {}
        for case, scale in (("small", 0.05), ("large", 0.08), ("zero", 0.0)):
            off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)).to(dev)
            locs = tps.tps_sample_locations(off, (H, W))
            gv, gl = tps_warp_bwd(vol, locs, g)
            rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(gv.float()).all() and torch.isfinite(gl).all()),
                  "non-finite warp gradient (%s)" % case)
            e_vol = (gv.float() - rv.float()).abs().max().item()
            e_loc = (gl - rl).abs().max().item()
            vmax, lmax = rv.float().abs().max().item(), rl.abs().max().item()
            if dtype == torch.float32:
                excess = ((gl - rl).abs() - 1e-4 * rl.abs()).max().item()
                check(excess <= 5e-5, "tps_warp_bwd %s grad_locs error beyond 5e-5 + 1e-4 rel: "
                      "%.3g" % (case, excess))
                check(e_vol <= 1e-5 * vmax, "tps_warp_bwd %s grad_vol error %.3g > 1e-5 x %.3g"
                      % (case, e_vol, vmax))
            else:
                check(e_vol <= 3e-2 and e_loc <= 3e-2 * lmax,
                      "tps_warp_bwd bf16 %s errors %.3g, %.3g" % (case, e_vol, e_loc / lmax))
            errs[case] = {"grad_vol": e_vol, "grad_vol_max": vmax,
                          "grad_locs": e_loc, "grad_locs_max": lmax}
            cover[case] = {"outside_share": float(((locs[..., 0] < -1) | (locs[..., 0] >= H)
                                                   | (locs[..., 1] < -1)
                                                   | (locs[..., 1] >= W)).float().mean())}
        # run-to-run: f32 atomics add in another order each run
        off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * 0.05).astype(np.float32)).to(dev)
        locs = tps.tps_sample_locations(off, (H, W))
        a, b = tps_warp_bwd(vol, locs, g)[0], tps_warp_bwd(vol, locs, g)[0]
        rerun = (a.float() - b.float()).abs().max().item()

        # the library yardstick: grid_sample's backward alone, one retained
        # graph per rotating buffer
        nbytes = vol.numel() * vol.element_size()
        grid = grid_of(torch, locs, H, W).to(dtype)
        bufs = []
        for v, gg in rotating(lambda: (vol.clone(), g.clone()), 2 * nbytes):
            vv = v.permute(0, 3, 1, 2).detach().requires_grad_(True)
            gr = grid.detach().requires_grad_(True)
            out = F.grid_sample(vv, gr, mode="bilinear", padding_mode="zeros",
                                align_corners=True)
            bufs.append((v, gg, (out, vv, gr, gg.permute(0, 3, 1, 2))))

        def library(buf):
            out, vv, gr, gg = buf[2]
            torch.autograd.grad(out, (vv, gr), gg, retain_graph=True)

        # bound: vol, g and locs read once, grad_vol and grad_locs written
        # once; operations per point and channel: 4 weighted scatters and
        # the two location terms (~16), per point ~20 for the weights
        res[name] = {
            "max_abs_err": max(e["grad_vol"] for e in errs.values()),
            "max_abs_err_locs": max(e["grad_locs"] for e in errs.values()),
            "errors": errs, "cases": cover, "rerun_grad_vol_diff": rerun,
            **measure(bufs, lambda b: tps_warp_bwd(b[0], locs, b[1]),
                      lambda b: tps._tps_warp_bwd_plain(b[0], locs, b[1]), library,
                      3 * nbytes + 2 * locs.numel() * 4, B * H * W * (16 * C + 20)),
        }
        del bufs
    return res


def nearest_warp_phase(torch, dev):
    """nearest_warp at the training shapes: B = 6, 192x192, C = 10 (x1, x2,
    m1, m2), 8 (dm1, dm2) and 2 (dx1, dx2), f32, at angles within +-20
    degrees; bit-exact against the plain gather for images and masks."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import augment
    from multimodal_segmentation_torch.ops.cuda_kernels import nearest_warp

    B, H, W = 6, 192, 192
    r = np.random.RandomState(2)
    th = torch.from_numpy(np.radians(np.array([0.0, 20.0, -20.0, 7.3, -13.9, 19.99],
                                              np.float32))).to(dev)
    locs = augment.rotation_locations(th, H, W)
    grid = grid_of(torch, locs, H, W)

    def library(v):
        return F.grid_sample(v.permute(0, 3, 1, 2), grid, mode="nearest",
                             padding_mode="border", align_corners=True)

    res = {}
    for C in (10, 8, 2):
        imgs = torch.from_numpy((r.rand(B, H, W, C) * 2 - 1).astype(np.float32)).to(dev)
        masks = torch.from_numpy((r.rand(B, H, W, C) > 0.7).astype(np.float32)).to(dev)
        err = 0.0
        for x in (imgs, masks):
            got, ref = nearest_warp(x, locs), augment._nearest_warp_plain(x, locs)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), "nearest_warp differs from its plain version (C=%d)" % C)
            err = max(err, (got - ref).abs().max().item())
        lib_share = (library(imgs).permute(0, 2, 3, 1) != nearest_warp(imgs, locs)
                     ).any(-1).float().mean().item()
        nbytes = imgs.numel() * 4
        # bound: vol and locs read once, out written once; ~6 operations a
        # point (round, clamp, index)
        res["C%d" % C] = {
            "max_abs_err": err, "bit_exact": True, "library_pixels_differing": lib_share,
            **measure(rotating(lambda: imgs.clone(), nbytes), lambda v: nearest_warp(v, locs),
                      lambda v: augment._nearest_warp_plain(v, locs), library,
                      2 * nbytes + locs.numel() * 4, B * H * W * 6, plain_iters=20),
        }
    # per training step: one launch at each C
    per_c = [res["C%d" % C] for C in (10, 8, 2)]
    step = {k: sum(r[k] for r in per_c)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")}
    step["max_abs_err"] = max(r["max_abs_err"] for r in per_c)
    step["bound_by"] = ("bytes" if step["bytes"] / HBM_BYTES_PER_S >= step["flops"] / F32_FLOPS
                        else "operations")
    res["per_step"] = step
    return res


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
        want = {"tps_warp_fwd": 2 * steps, "tps_warp_bwd": steps, "nearest_warp": 3 * steps}
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


def _kernel_kind(name):
    n = name.lower()
    if any(k in n for k in ("tps_warp_fwd", "tps_warp_bwd", "nearest_warp")):
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
                    help="slice, cross-device and train at the tiny config on "
                         "the CPU; no result line")
    ap.add_argument("--profile-train", action="store_true",
                    help="only profile full-width train steps on the card; "
                         "no result line")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "multimodal_segmentation_torch")):
        sys.exit("chip_smoke.py: the multimodal_segmentation_torch package is "
                 "not beside this script; run it from the repository")
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
        "nearest_warp": nearest_warp_phase(torch, dev),
    }
    emit("kernels", card=smi, **kern)

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

    # launches: the slice's (inference) plus the train phase's
    launches = {k: res["launches"].get(k, 0) + train["launches"][k] for k in train["launches"]}
    main_dtype = "bfloat16" if conf.eval_warp == "bf16" else "float32"
    src = "multimodal_segmentation_torch/csrc/"
    replaces = "multimodal_segmentation_tpu/ops/pallas_kernels.py:"
    summary = []
    for name, source, line, k, work in (
            ("tps_warp_fwd", "tps_warp.cu", 315, kern["tps_warp_fwd"][main_dtype],
             "B=24 192x192 C=8 %s (inference)" % main_dtype),
            ("tps_warp_bwd", "tps_warp_bwd.cu", 269, kern["tps_warp_bwd"]["float32"],
             "B=12 192x192 C=8 float32 (training)"),
            ("nearest_warp", "nearest_warp.cu", 416, kern["nearest_warp"]["per_step"],
             "B=6 192x192 float32, C=10+8+2: the 3 launches of one training step")):
        summary.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": replaces + str(line),
            "launches": launches[name],
            "launches_by_path": {"slice": res["launches"].get(name, 0),
                                 "train": train["launches"][name]},
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
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
