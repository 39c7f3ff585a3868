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
                `library_device_ms` and `library_host_ms` (tps_warp_fwd at
                the inference and training shapes in f32 and bf16, B = 36
                among them: automated pairing's 2K = 6 fusion directions;
                tps_warp_bwd at B = 36 too (`tps_warp_bwd_auto`);
                `rotation_auto`: automated pairing's 3+3+4+4-channel
                group; round_ste at (36, 8, 192, 192) too;
                tps_warp_bwd with small, large, zero, scattered,
                window-edge and border locations, g contiguous and
                channels-first; `rotation`: a training step's three
                group rotations, kernel and whole random_rotate_batch
                path, with wall times; round_ste; `bn_epilogue`: the
                eval-mode conv epilogue at three bf16 shapes of serving,
                bit for bit against the separate operations, with the
                plain chain's device time too; `thin_conv3d`: the 3D
                U-Net's first convolution at 16 and 2 tiles in bf16
                against its plain version and cuDNN, and one
                published-width forward's launches; `same_conv3d`: Swin
                UNETR's 48-output-channel convolutions at their four
                shapes in bf16 against the plain version and cuDNN, and
                one published-width window's launches; `launch_path`: host us
                of each part of a wrapper's launch; `flow`: tps_flow_dbg
                at the tool's shape and at B1's, the stages check of B1
                against a plain blend at its locations, the gap to
                tps_sample_locations, B5's share of B1's device time;
                `nearest_warp_3d`: B3's nearest_warp entry at the 3-D
                step's (32, 128, 128, 3) f32, volumes and masks, against
                its plain gather and grid_sample nearest, the card's
                rotation against the CPU's, and the step's two rotations)
  warp-general  (in the kernels line) B1's general entry (inverse mapping,
                orders 1-4, other control grids) at B = 12, 192x192, C = 8
                against its plain version, 2e-4 f32 / 2e-2 bf16; a
                coordinate ramp's warp against the plain locations, 1e-4
                px; the public tps_warp forward and backward (B2) against
                the plain route's autograd; every case timed against
                grid_sample, with its bound from the kernel's SASS counts
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
  train-bf16    the same at compute_dtype bfloat16 (f32 parameters,
                statistics, losses and Adam moments): the same checks, and
                its p50 over the f32 row's
  slice-bf16    the slice at eval_dtype bfloat16 (the tester's own bf16
                model from the same weights): the same checks, p50 per
                fusion over the slice row's, and the share of pixels whose
                argmax differs from the slice row's
  lockstep      the JAX package's bf16/f32 lockstep bound: 40 tiny
                step_supervised calls in f32 and in bf16 from the same
                weights, batches and draws; both losses fall, the largest
                relative divergence < 0.02, the endpoints < 0.01
  train-spade   the train phase at full dafnet_spade_chaos width (SPADE
                decoder), f32 and bf16, SPADE_STEPS timed steps
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
  train-auto    the train phase under automated pairing at full
                dafnet_chaos width (n_pairs 3, batch 6, 192x192), f32 and
                bf16, NEW_TRAIN_STEPS timed steps: 2/1/3/2 launches a step,
                B1 and B2 at B = 36, the balancer moves
  train-mmsdnet the same at full mmsdnet_chaos width: a batch is a
                supervised generator step (with its Z-regressor update) and
                a discriminator step, 3/1/3/6 launches a batch
  train-mmsdnet-remat
                full-width MMSDNet, f32 and bf16, remat_convs against without
                (and a rerun without, the yardstick): the first batch's
                metrics and state, the running statistics moved once, peak
                memory and p50 ms of each
  experiment-paths
                the CLI on dafnet_config_chaos --automatedpairing and on
                mmsdnet_config_chaos, --l_mix 0.5, one epoch of PATHS_STEPS
                batches, validation and the test, then --test on the same
                folder: logs (val_weight_0..2 sum to 1), step counts, the
                same results.csv, exact launches
  balancer-order
                the JAX package's learning check of the balancer (tiny,
                automated pairing, 6 epochs of 20 batches): the logged
                weights sum to 1 and the expert pair's is the largest
  chaos         the dress rehearsal (multimodal_segmentation_torch.tools.
                dress_rehearsal) at full dafnet_chaos width: a 20-volume
                CHAOS DICOM tree at the archive's profile, cold and warm
                ingest through the native reader and the ChaosLoader, then
                the CLI (one epoch of CHAOS_STEPS batches at l_mix 0.5, no
                --dataset) and `--test`: ingest seconds, slices per split,
                the epoch's parts, launches, Dice per fusion type
  train-3d      Cardiac3DSegmenter.step at full cardiac_3d width (batch 2,
                (16, 128, 128, 3), widths 16-128), f32 and bf16, on the
                cardiac loader's split-0 training studies: losses, ms per
                step, studies/s, exactly 2 nearest_warp launches a step and
                no other kernel, peak memory, every parameter moved, a
                profiler window by kind
  train-3d-cross-device
                the tiny 3-D config's first batch rotated on the card and on
                the CPU with the same angles: bit for bit equal
  experiment-3d the CLI on cardiac_3d_config, 2 epochs, then --test: seconds
                per epoch, validation and test Dice, the artifacts, the
                restored Dice within 1e-6, launches
  dp-kernels    B1, B2, B3 (rotate_group, nearest_warp) and B4 on the two
                halves of their main-path batches: the concatenation
                equals the whole call bit for bit (the JAX package's GSPMD
                batch rules, pallas_kernels.py:446-594)
  train-dp-nccl1
                an NCCL process group of world size 1 in this process: the
                full-width expert step (build_model's weights) through a
                data = 1 mesh against the mesh-free step and a second
                mesh-free run (the card's own run-to-run gap: B2's atomics),
                2 steps: the first forward bit for bit, the rest held as
                dp_check_against holds it; launches 2/1/3/2 a step, ms a
                step of both
  fused-adam    the full-width expert step with fused_adam against the
                per-leaf Adam (train-dp-nccl1's mesh-free run and its rerun
                as the yardstick): the first step compared, ms a step of each
  train-dp      two gloo ranks on the one card (torch.multiprocessing),
                full-width expert step at batch 3 + 3 against the one
                process on 6, same weights and noise (dp_check_against:
                the first forward's anatomy logits and rounding flips, its
                generator metrics within 1e-5 and gradients within 1e-3;
                after the first update, the one process's rerun as the
                yardstick), launches 2/1/3/2 a step on each rank, p50 ms
                over DP_TIMED steps after the compared ones (gloo through
                the host: not a scaling figure)
  train-tp      the same two ranks as a (1, 2) ('data', 'model') mesh: the
                full-width expert step with 22 leaves sharded over 'model'
                (min_features 256) against the mesh-free run: each rank
                holds half of each; the first step's generator metrics bit
                for bit, then dp_check_against; replicated leaves equal
                across 'model'; launches 2/1/3/2; p50 ms, peak memory, the
                bytes the weight gathers move a step
  train-3d-dp   the same two ranks: the full-width 3-D step on (1, 2) and
                (2, 1) meshes against the unsharded step, loss within
                2e-5, each gradient leaf within DP_3D_GRAD_REL (ReLU kinks
                aligned and counted), 2 B3 a step a rank, p50 ms, the
                halo's op
  experiment-dp the same two ranks: the tiny executor (early stop at epoch
                1 of 3, then the test) against one process and its rerun:
                training.csv within 1e-3 (or 10 times the rerun's gap), the
                stop, the SWA weights, one set of files, exact launches

On the card every line after env carries `card`, nvidia-smi's name and
power limit. Then a `total` line, nvidia-smi's line, the kernels summary
and, last, the result line. Any failed check raises, and the script exits
non-zero without a result line; so it does without a CUDA device, or
outside the repository. The checks that tests/test_torch_gpu.py makes on
the card are not made here again; the phases are listed once, in
phase_table.

  python3 chip_smoke.py                  # needs one CUDA device
  python3 chip_smoke.py --cpu-rehearsal  # every phase but env, build,
                                         # kernels and dp-kernels, in the
                                         # card run's order, at the tiny
                                         # config on the CPU with the plain
                                         # versions; no result line
  python3 chip_smoke.py --profile-train  # only a torch.profiler window over
                                         # full-width train steps on the card:
                                         # device time by kernel and by kind,
                                         # busy share; no result line
"""

import argparse
import contextlib
import csv
import dataclasses
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

# seeded weights that make inference exercise the warp: a sharper anatomy
# head (at init every softmax channel is < 0.5 and the rounded anatomy is
# empty) and a non-zero last LocNet Dense (zero at init: identity warp)
ANATOMY_GAIN = 5.0
DENSE1_STD = 1e-2
# train phase: 2 warm-up steps, then timed steps
TRAIN_WARMUP = 2
TRAIN_STEPS = 12
# experiment phase: steps an epoch, epochs before and after the resume
EXP_STEPS = 4
EXP_EPOCHS = 3
EXP_RESUME_EPOCHS = 4
# train-spade phase: timed steps (after TRAIN_WARMUP)
SPADE_STEPS = 6
# train-auto and train-mmsdnet phases: timed batches (after TRAIN_WARMUP)
NEW_TRAIN_STEPS = 6
# lockstep phase: step_supervised calls in each dtype (the JAX test's 40)
LOCKSTEP_STEPS = 40
# chaos phase: the fabricated tree (MMSEG_TPU_CHAOS_DIR) and the batches an
# epoch of its one epoch
CHAOS_ROOT = os.path.join(OUT_DIR, "chaos", "MR")
CHAOS_STEPS = 4
# experiment-paths phase: batches of its one epoch
PATHS_STEPS = 2
# train-3d phase: timed steps (after TRAIN_WARMUP) and the profiled ones
TRAIN3D_STEPS = 12
TRAIN3D_PROFILE_STEPS = 3
# experiment-3d phase: epochs of the CLI run (the preset's are 100)
EXP3D_EPOCHS = 2
# balancer-order phase (tiny): epochs and batches an epoch of the JAX
# package's learning check (tests/test_executor_variants.py:227-259)
BALANCER_EPOCHS = 6
BALANCER_STEPS = 20
# the data-parallel phases: steps compared with one process (they are the
# warm-up too), then timed steps; train-dp-nccl1's timed steps. One step is
# compared on the card: after an update its GAN losses (adv_X1 ~180 at the
# second step) turn lr-sized Adam differences at gradient entries near 0
# into differences of several % between any two runs that are not bit for
# bit the same (PERF.md §6); tests/test_torch_parallel.py compares
# two steps on the CPU, deterministic and tiny
DP_COMPARED = 1
DP_TIMED = 6
DP_NCCL1_TIMED = 3
# train-tp: timed steps after the compared one; the width from which a
# leaf is sharded over 'model' (JAX's default), and the leaves that gives
# at full dafnet_chaos width (22 of 226: 45,613,056 of 52,073,217
# parameters)
TP_TIMED = 2
TP_MIN_FEATURES = 256
TP_LEAVES = 22
# train-mmsdnet-remat and fused-adam: timed batches after the compared one
REMAT_TIMED = 2
FUSED_TIMED = 2
# train-3d-dp: each gradient leaf's largest difference over its largest
# entry. ReLU kinks are aligned (step_grads_3d); max-pool near-ties and the
# other order of the sums are not: on (2, 1) at full width the
# full-resolution InstanceNorm biases and convs, whose gradients sum
# 16 x 128 x 128 voxels with heavy cancellation, reach 5.2e-4 on the H100
# (1e-5 on the CPU at the tiny size; PERF.md §6)
DP_3D_GRAD_REL = 1e-3


_T0 = time.perf_counter()


def emit(phase, **fields):
    """One phase's JSON line; `at_s`: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _T0}), flush=True)


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


def call_bound(entry, *inputs):
    """The bound of one call of the port's operator `entry` on `inputs` (as
    its profiler record lists them), by the benchmark's count
    (benchmark/flops/kernels.py::call_bound_s): {"bound_ms": ...}."""
    from benchmark.flops import kernels

    names = {"torch.float32": "float", "torch.bfloat16": "c10::BFloat16"}
    s = kernels.call_bound_s("mmseg_cuda::" + entry, [tuple(t.shape) for t in inputs],
                             [names[str(inputs[0].dtype)]])
    return {"bound_ms": 1e3 * s}


def work_bound(moved, flops, f64_flops=0, bf16_flops=0):
    """The bound of work that benchmark/flops/kernels.py does not count: the
    larger of `moved` bytes over the HBM rate and the operations' time,
    `flops` over the f32 rate plus `f64_flops` over the f64 rate plus
    `bf16_flops` over the bf16 tensor-core rate (benchmark/flops/peaks.py)."""
    from benchmark.flops import peaks

    t_bytes = moved / peaks.HBM_BYTES_PER_S
    t_ops = (flops / peaks.F32_FLOPS + f64_flops / peaks.F64_FLOPS
             + bf16_flops / peaks.BF16_FLOPS)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "flops": flops, "f64_flops": f64_flops, "bf16_flops": bf16_flops}


def measure(bufs, kernel, plain, library, bound, plain_iters=10):
    """Time kernel(buf), plain(buf) and library(buf), each call on the next
    of the rotating buffers `bufs`, beside the bound of the work (`bound`:
    call_bound's or work_bound's). Where no PyTorch call computes the
    function, `library` is None and so are its times."""
    def cycled(fn):
        it = itertools.cycle(bufs)
        return lambda: fn(next(it))

    ms, ms_spread = time_ms(cycled(kernel))
    plain_ms, plain_spread = time_ms(cycled(plain), iters=plain_iters)
    out = {
        "ms": ms, "ms_spread": ms_spread,
        "device_ms": device_ms(cycled(kernel)),
        "host_ms": host_ms(cycled(kernel)),
        "plain_ms": plain_ms, "plain_ms_spread": plain_spread,
        "library_ms": None, "library_ms_spread": None,
        "library_device_ms": None, "library_host_ms": None, "host_over_library_host": None,
        **bound,
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


def fwd_measure(torch, vol, off):
    """tps_warp_fwd on vol (B, H, W, C) with offsets off (B, 25, 2), timed
    against its plain version and grid_sample (the library call)."""
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_fwd

    H, W = vol.shape[1:3]
    cp = tps.control_grid((5, 5), vol.device)

    def library(v, grid):
        return F.grid_sample(v.permute(0, 3, 1, 2), grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    wv = tps.tps_coefficients(off)
    grid = grid_of(torch, tps.tps_sample_locations(off, (H, W)), H, W).to(vol.dtype)
    out = measure(rotating(lambda: vol.clone(), vol.numel() * vol.element_size()),
                  lambda v: tps_warp_fwd(v, wv, cp), lambda v: tps._tps_warp_plain(v, off),
                  lambda v: library(v, grid), call_bound("tps_warp_fwd", vol, wv, cp))
    out["library_max_abs_diff"] = (library(vol, grid).permute(0, 2, 3, 1).float()
                                   - tps_warp_fwd(vol, wv, cp).float()).abs().max().item()
    return out


def warp_fwd_phase(torch, dev):
    """tps_warp_fwd at the inference shapes: B = 24 (a padded volume),
    192x192, C = 8 anatomy channels, bf16 and f32; and at the training
    shapes, B = 12 (both fusion directions of batch 6) and B = 36 (the
    automated loss's 2K = 6 fusion directions of batch 6), f32 and bf16."""
    import numpy as np

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_fwd

    H, W, C = 192, 192, 8
    r = np.random.RandomState(0)
    cp = tps.control_grid((5, 5), dev)

    def timed(vol, off):
        return fwd_measure(torch, vol, off)

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

    # the training shapes: B = 12 and 36, f32 and bf16, offsets like a
    # trained LocNet's
    for B, prefix in ((12, "train_"), (36, "train_auto_")):
        vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
        off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * 0.05).astype(np.float32)).to(dev)
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).replace("torch.", "")
            v = vol.to(dtype)
            err = (tps_warp_fwd(v, tps.tps_coefficients(off), cp).float()
                   - tps._tps_warp_plain(v, off).float()).abs().max().item()
            check(err <= tol, "tps_warp_fwd training shape B=%d %s error %.3g > %g"
                  % (B, name, err, tol))
            res[prefix + name] = {"shape": [B, H, W, C], "max_abs_err": err, **timed(v, off)}
    return res


# warp-general phase: the general entry's cases (name, inverse, order,
# cp_dims, dtypes); B1's main path (forward, order 2, 25 shared points)
# is warp_fwd_phase's
GENERAL_CASES = (
    ("inverse", True, 2, (5, 5), ("float32", "bfloat16")),
    ("order1", False, 1, (5, 5), ("float32",)),
    ("order3", False, 3, (5, 5), ("float32",)),
    ("order4", False, 4, (5, 5), ("float32",)),
    ("cp4x4", False, 2, (4, 4), ("float32",)),
)
# float64 operations (an FMA counted as 2) of B1's general entry, from
# cuobjdump -sass of its device functions for sm_90a: the basis
# of one (point, centre), its distance included: order 2 DADD 4, DMUL 4,
# DFMA 8 (the reduced log: 7 DFMA, 1 DMUL, 2 DADD); order 4 one DMUL more;
# order 1 DADD 2, DMUL 4, DFMA 6 (sqrt's fast path: MUFU.RSQ64H, 3 DMUL, 5
# DFMA); order 3 one DMUL more. An image's term of one (point, centre): 2
# DFMA. The bound counts the basis once a point where the centres are
# shared, once a (point, image) where they are not.
GENERAL_BASIS_F64 = {1: 18, 2: 24, 3: 19, 4: 25}
GENERAL_TERM_F64 = 4
# per (point, image): the affine rows and the scale to pixels, from the
# source's expression (2 DMUL, 1 DFMA, 2 DADD a coordinate)
GENERAL_POINT_F64 = 12


def general_bound(B, H, W, C, n_cp, order, per_image):
    """(f32 operations, f64 operations) of the general entry's work: the
    float64 flow (GENERAL_*_F64) and, per (point, image), ~20 f32
    operations for the corner weights and 8 a channel for the blend."""
    basis = (B if per_image else 1) * H * W * n_cp * GENERAL_BASIS_F64[order]
    f64 = basis + B * H * W * (n_cp * GENERAL_TERM_F64 + GENERAL_POINT_F64)
    return B * H * W * (20 + 8 * C), f64


def warp_general_phase(torch, dev):
    """B1's general entry (csrc/tps_warp.cu, tps_warp_general_kernel) at
    the main path's training shape, B = 12, 192x192, C = 8, offsets of
    +-0.025: the inverse mapping in f32 and bf16, orders 1, 3 and 4 and
    cp_dims (4, 4) forward in f32, against its plain version
    (tps._tps_warp_general_plain: the same coefficients and centres, the
    flow in float64) within 2e-4 in f32 and 2e-2 in bf16. The sample
    locations themselves: a coordinate ramp (channel 0 the row, channel 1
    the column, f32), whose bilinear blend is the location, warped at every
    case, within 1e-4 px of tps._general_locations where the four corners
    are inside. Then each case through the public tps_warp, forward and
    backward, with the counts set to 0 just before (the path's launches:
    one B1 general and one B2 a case): B2's grad_vol within 1e-5 of its
    largest entry of the plain route's autograd on the card, and the
    offsets' gradient (autograd through the solve) within 1e-3 of its
    largest entry (B2's location gradient is held to 5e-5 + 1e-4
    relative, warp_bwd_phase). Every case timed against its plain version
    and grid_sample at the plain version's locations, with its bound
    (general_bound); the inverse f32 case is the summary's row."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import cuda_kernels, tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_fwd

    B, H, W, C = 12, 192, 192, 8
    r = np.random.RandomState(12)
    vol32 = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
    w = torch.from_numpy(r.randn(B, H, W, C).astype(np.float32)).to(dev)
    ramp = torch.zeros(B, H, W, C, device=dev)
    ramp[..., 0] = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    ramp[..., 1] = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    res, splines = {}, {}
    cuda_kernels.reset_launch_counts()
    for name, inverse, order, dims, dtypes in GENERAL_CASES:
        n = dims[0] * dims[1]
        off = torch.from_numpy(((r.rand(B, n, 2) - 0.5) * 0.05).astype(np.float32)).to(dev)
        wv = tps.tps_coefficients(off, dims, inverse, order)
        cp = tps.tps_centres(off, dims, inverse).contiguous()
        splines[name] = (wv, cp, order)
        row = {"inverse": inverse, "order": order, "cp_dims": list(dims),
               "coef_absmax": wv.abs().max().item()}
        for dtype in dtypes:
            tol = 2e-4 if dtype == "float32" else 2e-2
            vol = vol32.to(getattr(torch, dtype))
            got = tps_warp_fwd(vol, wv, cp, order)
            ref = tps._tps_warp_general_plain(vol, wv, cp, order)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), "non-finite general warp (%s)" % name)
            err = (got.float() - ref.float()).abs().max().item()
            check(err <= tol, "tps_warp_fwd general %s %s error %.3g > %g"
                  % (name, dtype, err, tol))
            row[dtype] = {"max_abs_err": err,
                          "outside_share": (ref == 0).all(-1).float().mean().item()}
        locs = tps._general_locations(wv, cp, (H, W), order)
        seen = tps_warp_fwd(ramp, wv, cp, order)[..., :2].reshape(B, H * W, 2)
        y, x = locs[..., 0], locs[..., 1]
        inside = (y >= 0) & (y < H - 1) & (x >= 0) & (x < W - 1)
        gap = (seen - locs).abs().amax(-1)[inside].max().item()
        check(inside.float().mean().item() > 0.5, "ramp %s: few points inside" % name)
        check(gap <= 1e-4, "general warp %s: the ramp's locations %.3g px > 1e-4 from "
              "_general_locations" % (name, gap))
        row["ramp"] = {"max_px": gap, "inside_share": inside.float().mean().item()}
        res[name] = row
    fwd_checks = cuda_kernels.general_launch_count()

    # the public entry, forward and backward, against the plain route
    cuda_kernels.reset_launch_counts()
    for name, inverse, order, dims, _ in GENERAL_CASES:
        n = dims[0] * dims[1]
        off = torch.from_numpy(((r.rand(B, n, 2) - 0.5) * 0.05).astype(np.float32)).to(dev)
        grads = []
        for fn in (tps.tps_warp, tps._tps_warp_plain):
            v = vol32.clone().requires_grad_(True)
            o = off.clone().requires_grad_(True)
            (fn(v, o, dims, inverse, order) * w).sum().backward()
            grads.append((v.grad, o.grad))
        (gv, go), (rv, ro) = grads
        e_vol, e_off = (gv - rv).abs().max().item(), (go - ro).abs().max().item()
        top_vol, top_off = rv.abs().max().item(), ro.abs().max().item()
        check(e_vol <= 1e-5 * top_vol, "general warp %s grad_vol %.3g > 1e-5 x %.3g"
              % (name, e_vol, top_vol))
        check(e_off <= 1e-3 * top_off, "general warp %s offsets' gradient %.3g > 1e-3 x %.3g"
              % (name, e_off, top_off))
        res[name]["backward"] = {"grad_vol": e_vol, "grad_vol_max": top_vol,
                                 "grad_offsets": e_off, "grad_offsets_max": top_off}
    torch.cuda.synchronize()
    launches = {**cuda_kernels.launch_counts(),
                "tps_warp_fwd_general": cuda_kernels.general_launch_count()}
    want = {k: len(GENERAL_CASES) if k in ("tps_warp_fwd", "tps_warp_fwd_general",
                                           "tps_warp_bwd") else 0 for k in launches}
    check(launches == want, "warp-general launches %s != %s" % (launches, want))

    # every case timed: bytes vol read and out written once, wv and the
    # centres read once; operations general_bound's (float64 flow, which
    # benchmark/flops/kernels.py does not count)
    buffers = {}
    for name, _, _, _, dtypes in GENERAL_CASES:
        wv, cp, order = splines[name]
        n = cp.shape[-2]
        # grid_sample at the plain version's f32 locations (its flow in float64)
        locs = tps._general_locations(wv, cp, (H, W), order)
        for dtype in dtypes:
            vol = vol32.to(getattr(torch, dtype))
            grid = grid_of(torch, locs, H, W).to(vol.dtype)

            def library(v, grid=grid):
                return F.grid_sample(v.permute(0, 3, 1, 2), grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

            nbytes = vol.numel() * vol.element_size()
            if dtype not in buffers:
                buffers[dtype] = rotating(lambda: vol.clone(), nbytes)
            f32_ops, f64_ops = general_bound(B, H, W, C, n, order, cp.dim() == 3)
            m = measure(buffers[dtype],
                        lambda v, wv=wv, cp=cp, order=order: tps_warp_fwd(v, wv, cp, order),
                        lambda v, wv=wv, cp=cp, order=order: tps._tps_warp_general_plain(
                            v, wv, cp, order),
                        library, work_bound(2 * nbytes + wv.numel() * 4 + cp.numel() * 4,
                                            f32_ops, f64_ops))
            m["library_max_abs_diff"] = (library(vol).permute(0, 2, 3, 1).float()
                                         - tps_warp_fwd(vol, wv, cp, order).float()
                                         ).abs().max().item()
            res[name][dtype].update(m)
    del buffers
    timed = res["inverse"]["float32"]
    return {"shape": [B, H, W, C], "cases": res, "checked_launches": fwd_checks,
            "launches": launches, "max_abs_err": max(
                row[dt]["max_abs_err"] for row in res.values() for dt in ("float32", "bfloat16")
                if dt in row),
            "ramp_max_px": max(row["ramp"]["max_px"] for row in res.values()),
            "timed_case": "inverse float32",
            **{k: v for k, v in timed.items() if k not in ("max_abs_err", "outside_share")}}


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


def bwd_measure(torch, vol, g, locs, layout=""):
    """tps_warp_bwd on vol, g (B, H, W, C) at locs (B, H*W, 2), g
    contiguous or (layout) channels-first as the fuser hands it over, timed
    against its plain version and grid_sample's backward alone (the
    library call, one retained graph per rotating buffer)."""
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_bwd as bwd

    H, W = vol.shape[1:3]
    nbytes = vol.numel() * vol.element_size()
    grid = grid_of(torch, locs, H, W).to(vol.dtype)
    bufs = []
    for v, gg in rotating(lambda: (vol.clone(), g.clone()), 2 * nbytes):
        vv = v.permute(0, 3, 1, 2).detach().requires_grad_(True)
        gr = grid.detach().requires_grad_(True)
        out = F.grid_sample(vv, gr, mode="bilinear", padding_mode="zeros", align_corners=True)
        gk = gg.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) if layout else gg
        bufs.append((v, gk, (out, vv, gr, gg.permute(0, 3, 1, 2))))

    def library(buf):
        out, vv, gr, gg = buf[2]
        torch.autograd.grad(out, (vv, gr), gg, retain_graph=True)

    return measure(bufs, lambda b: bwd(b[0], locs, b[1]),
                   lambda b: tps._tps_warp_bwd_plain(b[0], locs, b[1]), library,
                   call_bound("tps_warp_bwd", vol, locs))


def warp_bwd_auto_phase(torch, dev):
    """tps_warp_bwd at the automated loss's shape: B = 36 (2K = 6 fusion
    directions of batch 6), 192x192, C = 8, f32, at the small, large and
    border locations of bwd_cases with the fuser's channels-first g; the
    bounds of warp_bwd_phase; timed at the small case."""
    import numpy as np

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_bwd as bwd

    B, H, W, C = 36, 192, 192, 8
    r = np.random.RandomState(2)
    vol = torch.from_numpy(r.rand(B, H, W, C).astype(np.float32)).to(dev)
    g = torch.from_numpy(r.randn(B, H, W, C).astype(np.float32)).to(dev)
    g = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    cases = {k: v for k, v in bwd_cases(torch, r, B, H, W, dev).items()
             if k in ("small", "large", "border")}
    errs = {}
    for case, locs in cases.items():
        rv, rl = tps._tps_warp_bwd_plain(vol, locs, g)
        gv, gl = bwd(vol, locs, g)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(gv).all() and torch.isfinite(gl).all()),
              "non-finite warp gradient at B=36 (%s)" % case)
        e_vol = (gv - rv).abs().max().item()
        vmax = rv.abs().max().item()
        excess = ((gl - rl).abs() - 1e-4 * rl.abs()).max().item()
        check(excess <= 5e-5, "tps_warp_bwd B=36 %s grad_locs error beyond 5e-5 + 1e-4 rel: "
              "%.3g" % (case, excess))
        check(e_vol <= 1e-5 * vmax, "tps_warp_bwd B=36 %s grad_vol error %.3g > 1e-5 x %.3g"
              % (case, e_vol, vmax))
        errs[case] = {"grad_vol": e_vol, "grad_vol_max": vmax,
                      "grad_locs": (gl - rl).abs().max().item()}
    return {"shape": [B, H, W, C], "max_abs_err": max(e["grad_vol"] for e in errs.values()),
            "errors": errs, **bwd_measure(torch, vol, g, cases["small"])}


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

        def timed(locs, layout):
            return bwd_measure(torch, vol, g, locs, layout)

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

    from benchmark.flops.kernels import rotation_bound_s
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

    bound = {"bound_ms": 1e3 * sum(rotation_bound_s(B, (H, W), sum(c for _, c in g))
                                   for g in ROTATION_GROUPS)}

    def kernel(buf):
        for grp in buf:
            ck.rotate_group(grp, cos_t, sin_t)

    res["path"] = {**measure(bufs, path, plain, library, bound), "wall_ms": wall(path)}
    res["kernel"] = {**measure(bufs, kernel, lambda buf: [
        augment._rotate_group_plain(grp, cos_t, sin_t) for grp in buf], library, bound),
        "wall_ms": wall(kernel), "max_abs_err": err}
    res["plain_wall_ms"] = wall(plain)
    return res


# the automated step's first rotation group (train/steps.py): x1_pairs,
# x2_pairs with n_pairs = 3 candidate slices, m1, m2
AUTO_ROTATION_GROUP = (("x1_pairs", 3), ("x2_pairs", 3), ("m1", 4), ("m2", 4))


def rotation_auto_phase(torch, dev):
    """rotate_group on the automated step's group of 3 + 3 + 4 + 4
    channels (a 3-channel f32 pixel is 12 bytes, so its arrays copy 4-byte
    vectors), B = 6, 192x192: bit-exact against the group concatenated,
    sampled by the plain gather and split, and against the kernel's plain
    version, for f32 and bf16 images and {0,1} masks at +-20 degrees and
    between, and at exact .5 ties on a 33x33 image. Timed, one launch,
    against its plain version and grid_sample nearest on the group
    concatenated beforehand."""
    import numpy as np
    import torch.nn.functional as F

    from benchmark.flops.kernels import rotation_bound_s
    from multimodal_segmentation_torch.ops import augment
    from multimodal_segmentation_torch.ops import cuda_kernels as ck

    B, H, W = 6, 192, 192
    r = np.random.RandomState(5)
    th = torch.from_numpy(np.radians(np.array(ROTATION_ANGLES_DEG, np.float32))).to(dev)
    checked = 0
    for (b, h, w, angles) in ((B, H, W, th), (4, 33, 33, tie_angles(torch, dev, 4))):
        cos_t, sin_t = torch.cos(angles), torch.sin(angles)
        for dtype in (torch.float32, torch.bfloat16):
            for masks in (False, True):
                arrays = _group_arrays(torch, r, b, h, w, AUTO_ROTATION_GROUP, masks, dtype, dev)
                ref = _rotation_reference(torch, arrays, angles)
                for got in (ck.rotate_group(arrays, cos_t, sin_t),
                            augment.random_rotate_batch(arrays, angles),
                            augment._rotate_group_plain(arrays, cos_t, sin_t)):
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                          "rotate_group 3+3+4+4 differs (%dx%d, %s, masks=%s)"
                          % (h, w, dtype, masks))
                checked += 1

    group = _group_arrays(torch, r, B, H, W, AUTO_ROTATION_GROUP, False, torch.float32, dev)
    nbytes = sum(a.numel() * 4 for a in group)
    bufs = rotating(lambda: [a.clone() for a in group], nbytes)
    cats = {id(buf): torch.cat(buf, -1).permute(0, 3, 1, 2) for buf in bufs}
    grid = grid_of(torch, augment.rotation_locations(th, H, W), H, W)
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    out = measure(bufs, lambda buf: ck.rotate_group(buf, cos_t, sin_t),
                  lambda buf: _rotation_reference(torch, buf, th),
                  lambda buf: F.grid_sample(cats[id(buf)], grid, mode="nearest",
                                            padding_mode="border", align_corners=True),
                  {"bound_ms": 1e3 * rotation_bound_s(
                      B, (H, W), sum(c for _, c in AUTO_ROTATION_GROUP))})
    return {"group": [list(a) for a in AUTO_ROTATION_GROUP], "shape": [B, H, W],
            "bit_exact": True, "groups_checked": checked, "max_abs_err": 0.0, **out}


# the volumetric step's rotation: B = 2 studies of D = 16 slices, 128x128,
# 3 sequences (cardiac_3d), one angle a study
VOLUME_ROTATION_ANGLES_DEG = (12.3, -7.9)


def nearest_warp_3d_phase(torch, dev):
    """The nearest_warp entry at the volumetric step's shape: rotate_batch
    on (B*D, 128, 128, 3) = (32, 128, 128, 3) f32, once for the volumes
    and once for the {0,1} masks (ops/augment.py::random_rotate_volumes).

    Checks, bit for bit: nearest_warp against its plain gather at the
    step's locations, for volumes and masks (the masks stay {0,1}); the
    whole random_rotate_volumes on the card against the same call on the
    CPU; rotation_locations on the card against the CPU's at angles whose
    sin or cos is exactly 0.5 (tie_angles) on a 33x33 image, so no .5 tie
    rounds another way. Timed, each array kind: one launch at given
    locations against its plain version and grid_sample nearest on a
    channels-first copy made beforehand; and the step's whole rotation
    (two rotate_batch calls with their locations)."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import augment
    from multimodal_segmentation_torch.ops import cuda_kernels as ck

    B, D, H, W, C = 2, 16, 128, 128, 3
    r = np.random.RandomState(6)
    th = torch.from_numpy(np.radians(np.array(VOLUME_ROTATION_ANGLES_DEG, np.float32))).to(dev)
    locs = augment.rotation_locations(th.repeat_interleave(D), H, W)
    vols = torch.from_numpy((r.rand(B, D, H, W, C) * 2 - 1).astype(np.float32)).to(dev)
    msks = torch.from_numpy((r.rand(B, D, H, W, C) > 0.7).astype(np.float32)).to(dev)
    out = {"shape": [B * D, H, W, C], "angles_deg": list(VOLUME_ROTATION_ANGLES_DEG)}
    err = {}
    for name, x in (("volumes", vols), ("masks", msks)):
        flat = x.reshape(B * D, H, W, C)
        got = ck.nearest_warp(flat, locs)
        ref = augment._nearest_warp_plain(flat, locs)
        torch.cuda.synchronize()
        err[name] = (got - ref).abs().max().item()
        check(torch.equal(got, ref), "nearest_warp (32, 128, 128, 3) %s differs" % name)
    rv, rm = augment.random_rotate_volumes(th, vols, msks)
    cv, cm = augment.random_rotate_volumes(th.cpu(), vols.cpu(), msks.cpu())
    check(torch.equal(rv.cpu(), cv) and torch.equal(rm.cpu(), cm),
          "random_rotate_volumes on the card differs from the CPU")
    check(set(rm.unique().tolist()) <= {0.0, 1.0}, "rotated masks are not {0,1}")
    ties = tie_angles(torch, dev, 4)
    on_card = augment.rotation_locations(ties, 33, 33)
    on_cpu = augment.rotation_locations(ties.cpu(), 33, 33)
    out["tie_locations"] = int(((on_cpu - on_cpu.floor()) == 0.5).sum())
    out["tie_locations_differing_from_cpu"] = int((on_card.cpu() != on_cpu).sum())
    check(out["tie_locations"] > 0, "the tie angles gave no .5 location")
    check(out["tie_locations_differing_from_cpu"] == 0,
          "rotation_locations on the card differ from the CPU's at tie angles")
    out.update(bit_exact=True, max_abs_err=max(err.values()))

    nbytes = vols.numel() * 4
    grid = grid_of(torch, locs, H, W)
    for name, x in (("volumes", vols), ("masks", msks)):
        bufs = rotating(lambda: x.reshape(B * D, H, W, C).clone(), nbytes)
        cf = {id(buf): buf.permute(0, 3, 1, 2).contiguous() for buf in bufs}
        out[name] = {"max_abs_err": err[name], **measure(
            bufs, lambda buf: ck.nearest_warp(buf, locs),
            lambda buf: augment._nearest_warp_plain(buf, locs),
            lambda buf: F.grid_sample(cf[id(buf)], grid, mode="nearest",
                                      padding_mode="border", align_corners=True),
            call_bound("nearest_warp", bufs[0], locs))}
    pairs = rotating(lambda: (vols.clone(), msks.clone()), 2 * nbytes)
    it = itertools.cycle(pairs)
    step = lambda: augment.random_rotate_volumes(th, *next(it))  # noqa: E731
    out["step_rotation"] = {"ms": time_ms(step)[0], "device_ms": device_ms(step)}
    return out


def round_ste_phase(torch, dev):
    """round_ste against torch.round (the plain version, and also the
    library call), bit for bit: values with exact .5 ties in f32 and bf16,
    at the training shape (12, 8, 192, 192: both modalities' anatomies of
    batch 6), the inference shape (38, 8, 192, 192: a 19-slice volume's two
    modalities), the automated training shape (36, 8, 192, 192: the K = 3
    pairs' anatomies of one dual-encoder call) and a size that is a
    multiple neither of 128 nor of a block, from an aligned and from an
    unaligned start. Timed at the three shapes in f32."""
    import numpy as np

    from multimodal_segmentation_torch.ops.cuda_kernels import round_ste

    r = np.random.RandomState(3)
    shapes = {"train": (12, 8, 192, 192), "inference": (38, 8, 192, 192),
              "train_auto": (36, 8, 192, 192), "odd": (1000003,)}
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
        # anatomy-like values in [0, 1]
        vol = torch.from_numpy(r.rand(*shape).astype(np.float32)).to(dev)
        res[name + "_float32"] = {
            "shape": list(shape), "max_abs_err": err, "bit_exact": True,
            **measure(rotating(lambda: vol.clone(), vol.numel() * 4), round_ste, torch.round,
                      torch.round, call_bound("round_ste", vol), plain_iters=60),
        }
    return res


def bn_epilogue_phase(torch, dev):
    """The eval-mode conv epilogue (csrc/bn_epilogue.cu) against its plain
    version (the separate operations), bit for bit, in bf16 at three shapes
    of a 38-slice study's serving path: the shared up path's last level
    (76, 64, 192, 192), a middle one (76, 512, 24, 24) and the bottleneck
    (76, 1024, 12, 12), ReLU on; timed there, contiguous NCHW and
    channels_last (the layout cuDNN hands the segmentor and the encoders'
    first level in serving). Its bound: c read once and the output written
    once."""
    from multimodal_segmentation_torch.nn.blocks import BatchNorm
    from multimodal_segmentation_torch.ops.cuda_kernels import bn_epilogue
    from multimodal_segmentation_torch.ops.epilogue import bn_epilogue_plain

    res = {}
    g = torch.Generator().manual_seed(7)
    for shape in ((76, 64, 192, 192), (76, 512, 24, 24), (76, 1024, 12, 12)):
        C = shape[1]
        norm = BatchNorm(C).eval()
        with torch.no_grad():
            norm.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
            norm.running_var.copy_(torch.rand(C, generator=g) * 2.0 + 1e-3)
            norm.weight.copy_(torch.rand(C, generator=g) + 0.5)
            norm.bias.copy_(torch.randn(C, generator=g) * 0.3)
        norm = norm.to(dev)
        cbias = (torch.randn(C, generator=g) * 0.3).to(dev)
        args = (cbias, norm.running_mean, norm.running_var, norm.weight, norm.bias, norm.eps,
                True)
        for layout in (torch.contiguous_format, torch.channels_last):
            c = (torch.randn(shape, device=dev) * 3.0).to(torch.bfloat16).contiguous(
                memory_format=layout)
            with torch.no_grad():
                got, ref = bn_epilogue(c, *args), bn_epilogue_plain(c, *args)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), "bn_epilogue %s %s differs from the plain chain"
                      % (shape, layout))
                err = (got.float() - ref.float()).abs().max().item()
                del got, ref
                nbytes = c.numel() * c.element_size()
                bufs = rotating(lambda: c.clone(), nbytes)
                row = measure(bufs, lambda b: bn_epilogue(b, *args),
                              lambda b: bn_epilogue_plain(b, *args), None,
                              work_bound(2 * nbytes, 5 * c.numel()))
                it = itertools.cycle(bufs)
                row["plain_device_ms"] = device_ms(lambda: bn_epilogue_plain(next(it), *args),
                                                   iters=10)
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            key = "x".join(map(str, shape)) + "_bfloat16"
            if layout == torch.channels_last:
                key += "_channels_last"
            res[key] = {"shape": list(shape), "max_abs_err": err, "bit_exact": True, **row}
            del bufs, c
            torch.cuda.empty_cache()
    return res


THIN_TILE = (3, 116, 132, 132)


def thin_conv3d_phase(torch, dev):
    """The thin-input convolution (csrc/thin_conv3d.cu) at the 3D U-Net's
    first convolution, (B, 3, 116, 132, 132) -> 32 channels in bf16, B =
    16 (a serving forward's tiles) and 2: within one bf16 rounding of its
    plain version (an exact sum rounded once, one sample at a time) on the
    same inputs, timed against cuDNN's F.conv3d (the legacy kernel it
    replaces). Its bound: x read once and the output written once (the
    products take ~0.16 ms at the bf16 tensor-core rate). Then one
    published-width bf16 forward of 16 tiles, the launch counts reset
    just before it: one thin_conv3d launch and the 14 epilogues."""
    import torch.nn.functional as F

    from multimodal_segmentation_torch import config
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.ops.thin_conv import thin_conv3d, thin_conv3d_plain

    def plain(x, w):
        return torch.cat([thin_conv3d_plain(x[i:i + 1], w) for i in range(x.shape[0])])

    res = {}
    g = torch.Generator(device=dev).manual_seed(21)
    w = (torch.randn(32, 3, 3, 3, 3, device=dev, generator=g) * 0.157).bfloat16()
    eps = torch.finfo(torch.bfloat16).eps
    for B in (16, 2):
        x = torch.rand(B, *THIN_TILE, device=dev, generator=g).bfloat16()
        with torch.no_grad():
            got, ref = thin_conv3d(x, w).float(), plain(x, w).float()
            torch.cuda.synchronize()
            gap = (got - ref).abs()
            check(bool((gap <= eps * ref.abs() + 1e-3).all()),
                  "thin_conv3d B=%d differs from its plain version by %g" % (B, gap.max().item()))
            err = gap.max().item()
            del got, ref, gap
            out_bytes = B * 32 * 114 * 130 * 130 * 2
            bufs = rotating(lambda: x.clone(), x.numel() * 2)
            row = measure(bufs, lambda b: thin_conv3d(b, w), lambda b: plain(b, w),
                          lambda b: F.conv3d(b, w), work_bound(x.numel() * 2 + out_bytes, 0),
                          plain_iters=2)
        row["flops"] = 2 * 81 * 32 * B * 114 * 130 * 130
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        res["B=%d" % B] = {"shape": [B, *THIN_TILE], "max_abs_err": err, **row}
        del bufs, x
        torch.cuda.empty_cache()

    net, _ = Cardiac3DSegmenter(config.unet3d_cicek(), device=dev).init(0)
    x = torch.rand(16, *THIN_TILE, device=dev, generator=g).bfloat16()
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        net(x)
        torch.cuda.synchronize()
    launches = cuda_kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(bn_epilogue=14, thin_conv3d=1)
    check(launches == want, "unet3d forward launches %s != %s" % (launches, want))
    res["forward"] = {"tiles": 16, "dtype": "bfloat16", "launches": launches}
    del net, x
    torch.cuda.empty_cache()
    return res


SAME_SHAPES = ((1, 48, 128, 128, 128), (1, 96, 128, 128, 128), (1, 48, 64, 64, 64),
               (1, 96, 64, 64, 64))


def same_conv3d_phase(torch, dev):
    """The 48-output-channel same convolution (csrc/same_conv3d.cu) at Swin
    UNETR's four shapes, (1, C, S, S, S) -> 48 channels in bf16, C 48 and
    96, S 128 and 64: within one bf16 rounding of its plain version (an
    exact sum rounded once) on the same channels_last_3d inputs, timed
    against cuDNN's F.conv3d(padding=1) (the sm80 kernel it replaces). Its
    bound: the products at the bf16 tensor-core rate (input read and
    output written once take less than half that). Then one
    published-width bf16 Swin UNETR forward of one 128^3 window, the
    launch counts reset just before it: 7 same_conv3d, 1 thin_conv3d."""
    import torch.nn.functional as F

    from multimodal_segmentation_torch import config
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.ops.same_conv import (
        pack_weight,
        same_conv3d,
        same_conv3d_plain,
    )

    res = {}
    g = torch.Generator(device=dev).manual_seed(25)
    eps = torch.finfo(torch.bfloat16).eps
    for shape in SAME_SHAPES:
        n, c, d, h, w = shape
        x = torch.randn(*shape, device=dev, generator=g).bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        wt = (torch.randn(48, c, 3, 3, 3, device=dev, generator=g) / (27 * c) ** 0.5).bfloat16()
        wp = pack_weight(wt)
        wcl = wt.contiguous(memory_format=torch.channels_last_3d)
        with torch.no_grad():
            got, ref = same_conv3d(x, wt, wp).float(), same_conv3d_plain(x, wp).float()
            torch.cuda.synchronize()
            gap = (got - ref).abs()
            check(bool((gap <= eps * ref.abs() + 1e-3).all()),
                  "same_conv3d %s differs from its plain version by %g" % (shape, gap.max().item()))
            err = gap.max().item()
            del got, ref, gap
            flops = 2 * 27 * c * 48 * n * d * h * w
            bufs = rotating(lambda: x.clone(memory_format=torch.channels_last_3d), x.numel() * 2)
            row = measure(bufs, lambda b: same_conv3d(b, wt, wp), lambda b: same_conv3d_plain(b, wp),
                          lambda b: F.conv3d(b, wcl, padding=1),
                          work_bound(x.numel() * 2 + n * 48 * d * h * w * 2, 0, bf16_flops=flops),
                          plain_iters=2)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["library_bound_share"] = row["bound_ms"] / row["library_device_ms"]
        res[str(shape)] = {"shape": list(shape), "max_abs_err": err, **row}
        del bufs, x, wt, wp, wcl
        torch.cuda.empty_cache()

    net, _ = Cardiac3DSegmenter(config.swin_unetr_brats(), device=dev).init(0)
    x = torch.rand(1, 4, 128, 128, 128, device=dev, generator=g).bfloat16()
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        net(x)
        torch.cuda.synchronize()
    launches = cuda_kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(thin_conv3d=1, same_conv3d=7)
    check(launches == want, "swin window forward launches %s != %s" % (launches, want))
    res["forward"] = {"windows": 1, "dtype": "bfloat16", "launches": launches}
    del net, x
    torch.cuda.empty_cache()
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
            # points read once; the basis once a point (25 terms of ~9
            # operations, a logf counted as one), and per point and image
            # the sums (25 x 2 FMAs) and ~10 for the affine term and scaling
            nbytes = got.numel() * 4
            bufs = rotating(lambda: wv.clone(), nbytes)
            keep = collections.deque(maxlen=len(bufs))
            out["stages_max_abs_diff"] = stages
            out.update(measure(bufs, lambda w: keep.append(tps_flow_dbg(w, cp, (H, W))),
                               lambda w: tps._tps_flow_stage_plain(w, cp, (H, W)), None,
                               work_bound(nbytes + wv.numel() * 4 + cp.numel() * 4,
                                          H * W * 25 * 9 + B * H * W * (25 * 4 + 10))))
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
    """The seeded changes named at ANATOMY_GAIN / DENSE1_STD (every anatomy
    head: DAFNet's one, MMSDNet's two)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith("conv_anatomy"):
                m.weight.mul_(ANATOMY_GAIN)
        d1 = model.fuser.locnet.Dense_1
        d1.weight.copy_(torch.randn(d1.weight.shape, generator=g) * DENSE1_STD)
        d1.bias.copy_(torch.randn(d1.bias.shape, generator=g) * DENSE1_STD)


def _numpy_weights(torch, model, seed):
    """Every kernel of `model` drawn again from numpy's RandomState(seed),
    in module order, from Flax's truncated normal (|x| <= 2, by rejection)
    at the module's own variance scaling (nn/blocks.py::_fan), and every
    spectral `u` from U[-1, 1): the same values on every machine and torch
    version. torch's trunc_normal_ draws other values under torch 2.11
    (the H100 machine) than under 2.13 from one seed."""
    import numpy as np

    from multimodal_segmentation_torch.nn import blocks

    r = np.random.RandomState(seed)

    def truncated(shape):
        x = r.standard_normal(shape)
        out = np.abs(x) > 2.0
        while out.any():
            x[out] = r.standard_normal(int(out.sum()))
            out = np.abs(x) > 2.0
        return x

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, blocks.Conv2d):
                kk = m.kernel_size[0] * m.kernel_size[1]
                fans = (m.in_channels * kk, m.out_channels * kk)
            elif isinstance(m, blocks.Linear) and m.init_kind != "zeros":
                fans = (m.in_features, m.out_features)
            else:
                continue
            scale, fan = blocks._fan(m.init_kind, *fans)
            std = math.sqrt(scale / fan) / blocks._TRUNC_STD
            m.weight.copy_(torch.from_numpy((truncated(tuple(m.weight.shape)) * std)
                                            .astype(np.float32)))
            if hasattr(m, "u"):
                m.u.copy_(torch.from_numpy(r.uniform(-1.0, 1.0, tuple(m.u.shape))
                                           .astype(np.float32)))


def _mean_dice(folder):
    with open(os.path.join(folder, "results.csv")) as f:
        rows = list(csv.reader(f, skipinitialspace=True))[1:]
    return sum(float(r[1]) for r in rows) / len(rows), len(rows)


def slice_phase(torch, conf, device, reference=None):
    """ModelTester.test_modality('t2') with its predict_mask calls timed.
    Under conf.eval_dtype the tester predicts with its own model at that
    dtype, built from the same weights. Returns (model, warm volume,
    result, the argmax of every predict_mask call, in call order);
    `reference`, the f32 row's (argmaxes, p50 ms per volume), adds the
    share of pixels whose argmax differs from it (over the padded volumes
    predict_mask sees) and each p50 over the f32 row's."""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.eval import ModelTester
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels

    on_card = device == "cuda"
    model = build_model(conf, device=device)
    _seed_weights(torch, model, conf.seed)
    tester = ModelTester(model, conf, device=device)
    model = tester.model
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

    times, argmaxes = {}, []
    predict = model.predict_mask

    def timed(modality_index, fusion_type, images, device):
        sync()
        t0 = time.perf_counter()
        out = predict(modality_index, fusion_type, images, device=device)
        sync()
        times.setdefault(fusion_type, []).append(time.perf_counter() - t0)
        check(out.shape == (images[0].shape[0],) + tuple(conf.input_hw) + (conf.num_masks + 1,),
              "predict_mask shape %s" % (tuple(out.shape),))
        check(out.dtype == torch.float32, "predict_mask dtype %s" % out.dtype)
        check(bool(torch.isfinite(out).all()), "non-finite masks")
        check((out.sum(-1) - 1).abs().max().item() < 1e-4, "masks do not sum to 1")
        argmaxes.append(out.argmax(-1).to(torch.uint8).cpu())
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
        want = epilogues(conf)["predict"] * sum(len(v) for v in times.values())
        check(launches["bn_epilogue"] == want,
              "bn_epilogue launches %d != %d" % (launches["bn_epilogue"], want))
    p50 = {k: 1e3 * sorted(v)[len(v) // 2] for k, v in times.items()}
    out = {
        "config": "dafnet_chaos" if conf.input_hw == (192, 192) else "tiny",
        "device": str(device),
        "compute_dtype": str(next(iter(model.enc_anatomy.parameters())).dtype) + " weights, "
                         + str(model.enc_anatomy.dtype) + " activations",
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
    if reference is not None:
        ref_argmaxes, ref_p50 = reference
        check(len(ref_argmaxes) == len(argmaxes), "%d predict_mask calls, the f32 row made %d"
              % (len(argmaxes), len(ref_argmaxes)))
        differ = sum(int((a != b).sum()) for a, b in zip(argmaxes, ref_argmaxes))
        out["argmax_differ_share_vs_f32"] = differ / sum(a.numel() for a in argmaxes)
        out["p50_over_f32"] = {k: p50[k] / v for k, v in ref_p50.items()}
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return model, warm, out, argmaxes


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


# Kernel launches on the card of each call that launches any, by kernel
# (B1 tps_warp_fwd, B2 tps_warp_bwd, B3 nearest_warp, B4 round_ste). A
# DAFNet step, expert or automated: 2 B1 (the loss's fusion directions, 12
# or 2K x 6 = 36 of them, and the fake pools'), 1 B2, 3 B3 (the rotation
# groups), 2 B4 (the loss's anatomies, the pools'). An MMSDNet generator
# step: 2 B1 (the loss's two directions; the Z-regressor's two in one
# call), 1 B2, 1 B3, 4 B4 (two private heads in the loss and in the
# Z-regressor); its discriminator step: 1 B1 (the pool), 2 B3 (dm; dx1 and
# dx2), 2 B4. A predict_mask call: one B4 an anatomy head, one B1 for
# 'def' and 'max'; the balancer's validation: n_pairs + 1 B4.
STEP_LAUNCHES = {
    "dafnet_step": {"tps_warp_fwd": 2, "tps_warp_bwd": 1, "nearest_warp": 3, "round_ste": 2},
    "mmsdnet_gen": {"tps_warp_fwd": 2, "tps_warp_bwd": 1, "nearest_warp": 1, "round_ste": 4},
    "mmsdnet_disc": {"tps_warp_fwd": 1, "tps_warp_bwd": 0, "nearest_warp": 2, "round_ste": 2},
}
KERNEL_NAMES = ("tps_warp_fwd", "tps_warp_bwd", "nearest_warp", "round_ste", "tps_flow_dbg",
                "bn_epilogue", "thin_conv3d", "same_conv3d")


def epilogues(conf):
    """Conv epilogue launches (bn_epilogue) of each kind of call at conf's
    UNet depth d: one a BatchNorm'd convolution run in eval mode on the
    card, none in train mode. A single-path encoder has 5d + 2 (2d down, 2
    in the bottleneck, 3d up), DAFNet's dual encoder 7d + 2 (two private
    down paths), the segmentor 2. A DAFNet step: the fake pools' dual
    encoder and segmentor; an MMSDNet generator step: the Z-regressor's two
    encoders; its discriminator step: the pool's two encoders and the
    segmentor; predict_mask: the anatomies and the segmentor; an image
    callback epoch: the anatomies; the balancer's validation: n_pairs + 1
    single-path encodes. At dafnet_chaos's d = 4: 32 a step and a
    predict_mask."""
    d = conf.anatomy_encoder.downsample
    single, dual, seg = 5 * d + 2, 7 * d + 2, 2
    anatomies = 2 * single if conf.model == "mmsdnet" else dual
    return {"dafnet_step": dual + seg, "mmsdnet_gen": 2 * single, "mmsdnet_disc": 2 * single + seg,
            "predict": anatomies + seg, "image_epoch": anatomies,
            "balancer_validation": (conf.n_pairs + 1) * single}


def launches_of(calls, conf):
    """{kernel: launches} of {step kind: calls}, by STEP_LAUNCHES and
    epilogues(conf)."""
    out = {k: sum(n * STEP_LAUNCHES[kind].get(k, 0) for kind, n in calls.items())
           for k in KERNEL_NAMES}
    out["bn_epilogue"] = sum(n * epilogues(conf)[kind] for kind, n in calls.items())
    return out


def launches_per_batch(conf):
    """Kernel launches of one train_phase batch on the card: a DAFNet step
    (2/1/3/2, 32 epilogues at full width), or MMSDNet's generator and
    discriminator steps (3/1/3/6, 90)."""
    if conf.model == "mmsdnet":
        return launches_of({"mmsdnet_gen": 1, "mmsdnet_disc": 1}, conf)
    return launches_of({"dafnet_step": 1}, conf)


def _train_setup(torch, conf, device):
    """(model, train state, step, batch iterator) at `conf`, with the
    slice's seeded weights, on the batches of the executor's assembly from
    the synthetic loader's split-0 training data. A step is one batch:
    DAFNet's step_supervised (expert or automated pairing), or MMSDNet's
    step_supervised then step_discriminator."""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.data.batches import TrainingData
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.train import create_train_state, make_steps

    loader = init_loader("synthetic", hw=conf.input_hw)
    loader.modalities = list(conf.modality)
    model = build_model(conf, device=device)
    _seed_weights(torch, model, conf.seed)
    steps = make_steps(model, conf)

    def step(ts, batch):
        ts, metrics = steps.step_supervised(ts, batch["sup"])
        if conf.model == "mmsdnet":
            ts, disc = steps.step_discriminator(ts, batch["disc"])
            metrics = {**metrics, **disc}
        return ts, metrics

    return (model, create_train_state(model, conf), step,
            TrainingData(conf, loader).assembled_batches())


def train_phase(torch, conf, device, warmup, steps):
    """`warmup` then `steps` timed batches of _train_setup's step on the
    synthetic loader's training split, as the JAX package's executors
    assemble them: every metric, ms per batch, slices/s, launches (exactly
    launches_per_batch a batch on the card), peak memory, which parameters
    moved."""
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
        want = {k: v * steps for k, v in launches_per_batch(conf).items()}
        check(launches == want, "train launches %s != %s" % (launches, want))
    moved = {n: max((p.detach() - b).abs().max().item()
                    for p, b in zip(getattr(model, n).parameters(), before[n])) for n in names}
    # the expert loss does not reach the balancer; the automated one does
    frozen = ["balancer"] if conf.model == "dafnet" and not conf.automatedpairing else []
    check(all(moved[n] > 0 for n in names if n not in frozen),
          "a component did not move: %s" % moved)
    check(all(moved[n] == 0.0 for n in frozen), "the balancer moved: %s" % moved)
    ms = sorted(1e3 * t for t in times)
    p50 = ms[len(ms) // 2]
    out = {
        "config": conf.folder,
        "automatedpairing": conf.automatedpairing,
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
    batch = next(batches)["sup"]
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


def lockstep_phase(torch, device):
    """The JAX package's bf16/f32 lockstep bound
    (tests/test_mixed_precision.py:61-114), step for step: the tiny DAFNet
    config, the same 8 batches from np.random.RandomState(0), LOCKSTEP_STEPS
    step_supervised calls in f32 and then in bf16 from the same seeded
    weights and the same draws (the train state's generator, seeded alike).
    Both losses fall from the first step to the last, the largest relative
    divergence of the bf16 loss from the f32 one stays below 0.02, and the
    endpoints differ by less than 0.01 relative."""
    import numpy as np

    from multimodal_segmentation_torch import config
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state

    def run(dtype):
        conf = config.tiny_test_config("dafnet")
        conf.compute_dtype = dtype
        model = build_model(conf, device=device)
        ts, steps_fn = create_train_state(model, conf), DAFNetSteps(model, conf).step_supervised
        r = np.random.RandomState(0)
        B, (H, W), nm = conf.batch_size, conf.input_hw, conf.num_masks
        batches = [{k: (r.rand(B, H, W, c) * (2 if "x" in k else 1) - (1 if "x" in k else 0))
                    .astype(np.float32)
                    for k, c in [("x1", 1), ("x2", 1), ("m1", nm), ("m2", nm),
                                 ("dm1", nm), ("dm2", nm), ("dx1", 1), ("dx2", 1)]}
                   for _ in range(8)]
        out = []
        for i in range(LOCKSTEP_STEPS):
            ts, m = steps_fn(ts, batches[i % 8])
            out.append(float(m["loss"]))
        return np.asarray(out)

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lf, lb = run("float32"), run("bfloat16")
    seconds = time.perf_counter() - t0
    launches = cuda_kernels.launch_counts()
    rel = np.abs(lf - lb) / np.maximum(np.abs(lf), 1e-6)
    end = abs(lf[-1] - lb[-1]) / abs(lf[-1])
    check(np.isfinite(lf).all() and np.isfinite(lb).all(), "non-finite lockstep loss")
    check(lf[-1] < lf[0] and lb[-1] < lb[0], "a lockstep run did not train: f32 %.4f -> %.4f, "
          "bf16 %.4f -> %.4f" % (lf[0], lf[-1], lb[0], lb[-1]))
    check(rel.max() < 0.02, "bf16 loss diverged from f32 by %.4f (>= 0.02)" % rel.max())
    check(end < 0.01, "lockstep endpoints differ by %.4f (>= 0.01)" % end)
    if device == "cuda":
        n = 2 * LOCKSTEP_STEPS
        want = {"tps_warp_fwd": 2 * n, "tps_warp_bwd": n, "nearest_warp": 3 * n,
                "round_ste": 2 * n, "tps_flow_dbg": 0,
                "bn_epilogue": n * epilogues(config.tiny_test_config("dafnet"))["dafnet_step"],
                "thin_conv3d": 0, "same_conv3d": 0}
        check(launches == want, "lockstep launches %s != %s" % (launches, want))
    return {"config": "tiny", "device": str(device), "steps": LOCKSTEP_STEPS, "seconds": seconds,
            "max_rel_divergence": float(rel.max()), "mean_rel_divergence": float(rel.mean()),
            "endpoint_rel_diff": float(end), "loss_f32": lf.tolist(), "loss_bf16": lb.tolist(),
            "launches": launches}


class _Counted:
    """Counts, while it is entered, the calls of the steps and of
    predict_mask that launch kernels: DAFNet steps, MMSDNet generator and
    discriminator steps, predict_mask calls and those that warp, and the
    balancer's validations."""

    def __init__(self):
        from multimodal_segmentation_torch.models.base import MaskPredictor
        from multimodal_segmentation_torch.train.executor import DAFNetExecutor
        from multimodal_segmentation_torch.train.steps import DAFNetSteps, MMSDNetSteps

        self.n = {"dafnet_step": 0, "mmsdnet_gen": 0, "mmsdnet_disc": 0, "predict": 0,
                  "warped": 0, "balancer_validation": 0}
        self.targets = [(DAFNetSteps, "_step", "dafnet_step"),
                        (MMSDNetSteps, "_gen_step", "mmsdnet_gen"),
                        (MMSDNetSteps, "step_discriminator", "mmsdnet_disc"),
                        (MaskPredictor, "predict_mask", "predict"),
                        (DAFNetExecutor, "validate_balancer_weights", "balancer_validation")]
        self.saved = []

    def __enter__(self):
        for cls, name, key in self.targets:
            fn = getattr(cls, name)
            self.saved.append((cls, name, fn))

            def counted(*args, _fn=fn, _key=key, **kw):
                self.n[_key] += 1
                if _key == "predict":
                    ftype = args[2] if len(args) > 2 else kw["fusion_type"]
                    self.n["warped"] += ftype in ("def", "max")
                return _fn(*args, **kw)

            setattr(cls, name, counted)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)
        self.saved = []

    def want(self, conf, image_epochs):
        """The kernel launches those calls, and the image callback's
        anatomy encodes in `image_epochs` epochs, make on the card."""
        n = self.n
        out = launches_of({k: n[k] for k in STEP_LAUNCHES}, conf)
        heads = 2 if conf.model == "mmsdnet" else 1
        out["tps_warp_fwd"] += n["warped"]
        out["round_ste"] += (heads * (n["predict"] + image_epochs)
                             + (conf.n_pairs + 1) * n["balancer_validation"])
        ep = epilogues(conf)
        out["bn_epilogue"] += (ep["predict"] * n["predict"] + ep["image_epoch"] * image_epochs
                               + ep["balancer_validation"] * n["balancer_validation"])
        return out


def experiment_paths_phase(torch, device, presets):
    """This slice's two CLI paths at full width on the synthetic data:
    `--config dafnet_config_chaos --automatedpairing --l_mix 0.5` and
    `--config mmsdnet_config_chaos --l_mix 0.5`, each one epoch of
    PATHS_STEPS batches (both generator paths run), validation and the
    test; then `--test` on the same folder, which restores the checkpoint
    and writes the same results. Checks: the step counts, the logs finite,
    automated pairing's val_weight_0..2 summing to 1 within 1e-3, MMSDNet's
    four validation logs, 12 results.csv each, and on the card the launches
    of every step, predict_mask call, image callback and balancer
    validation exactly."""
    from multimodal_segmentation_torch import experiment
    from multimodal_segmentation_torch.ops import cuda_kernels

    on_card = device == "cuda"
    work = os.path.join(OUT_DIR, "experiment_paths")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    out = {}
    try:
        os.chdir(work)
        for preset in presets:
            flags = ["--config", *preset, "--split", "0", "--l_mix", "0.5", "--epochs", "1",
                     "--dataset", "synthetic", "--test_dataset", "synthetic", "--device", device]
            name = preset[0].replace("_config_chaos", "") + ("-auto" if len(preset) > 1 else "")
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with _Counted() as counted:
                ex = experiment.Experiment().run(flags, steps_per_epoch=PATHS_STEPS)
            train_s = time.perf_counter() - t0
            launches = cuda_kernels.launch_counts()
            conf = ex.conf
            folder = os.path.join(work, conf.folder)
            with open(os.path.join(folder, "training.csv")) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0].values()),
                  "%s: training.csv %s" % (name, rows))
            per_batch = 3 if conf.model == "mmsdnet" else 2
            check(ex.final_state.step == per_batch * PATHS_STEPS,
                  "%s: %d steps" % (name, ex.final_state.step))
            logs = {k: float(v) for k, v in rows[0].items()}
            if conf.automatedpairing:
                w = [logs["val_weight_%d" % j] for j in range(conf.n_pairs)]
                check(abs(sum(w) - 1.0) <= 1e-3, "%s: val weights %s" % (name, w))
            else:
                check({"val_loss_mod2_s1def", "rec_Z", "dis_M"} <= set(logs)
                      and "val_loss_mod1_fused" not in logs, "%s: logs %s" % (name, sorted(logs)))
            if on_card:
                want = counted.want(conf, image_epochs=1)
                check(launches == want, "%s launches %s != %s" % (name, launches, want))

            results = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(folder) for f in fs
                             if f == "results.csv")
            check(len(results) == 12, "%s: %d results.csv" % (name, len(results)))
            first = {p: open(p).read() for p in results}
            cuda_kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with _Counted() as counted_test:
                experiment.Experiment().run(flags + ["--test"])
            test_s = time.perf_counter() - t0
            test_launches = cuda_kernels.launch_counts()
            check({p: open(p).read() for p in results} == first,
                  "%s: --test wrote other results" % name)
            if on_card:
                want = counted_test.want(conf, image_epochs=0)
                check(test_launches == want, "%s --test launches %s != %s"
                      % (name, test_launches, want))
            dice = {os.path.basename(os.path.dirname(p)): _mean_dice(os.path.dirname(p))[0]
                    for p in results}
            check(all(0.0 <= d <= 1.0 for d in dice.values()), "%s: Dice %s" % (name, dice))
            out[name] = {
                "config": conf.folder, "model": conf.model,
                "automatedpairing": conf.automatedpairing, "l_mix": conf.l_mix,
                "steps": ex.final_state.step, "train_and_test_s": train_s, "test_s": test_s,
                "epoch_seconds": ex.epoch_seconds[0], "logs": logs,
                "launches": launches, "test_launches": test_launches, "calls": counted.n,
                "test_dice": dice,
            }
            if on_card:
                out[name]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            del ex
            if on_card:
                torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    return out


def balancer_order_phase(torch, device):
    """The JAX package's learning check of the balancer
    (tests/test_executor_variants.py:227-259, marked slow there): the tiny
    config under automated pairing, BALANCER_EPOCHS epochs of
    BALANCER_STEPS batches, SWA from epoch 0, on the synthetic fixture
    (organ centres drift along the slice axis, so the candidate pairs
    differ in alignment). Fails unless the last epoch's logged val_weight_j
    sum to 1 within 1e-3 and val_weight_0, the expert pair, exceeds the
    others. Launches exact on the card.

    Weights: _numpy_weights from conf.seed, then the script's seeded
    changes (_seed_weights: a sharper anatomy head, a non-zero LocNet
    head). The outcome depends on the start: from torch's own draws, which
    differ between torch versions, the balancer's untrained head ranked a
    neighbour first on one machine and the expert on another, and from
    the unsharpened head the rounded anatomies of most slices were empty,
    which makes every candidate's overlap 1."""
    from multimodal_segmentation_torch import config
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.train.executor import make_executor

    conf = config.tiny_test_config()
    conf.dataset_name = conf.test_dataset = "synthetic"
    conf.automatedpairing = True
    conf.epochs, conf.steps_per_epoch, conf.swa_start_epoch = BALANCER_EPOCHS, BALANCER_STEPS, 0
    conf.folder = os.path.join(OUT_DIR, "balancer_order")
    shutil.rmtree(conf.folder, ignore_errors=True)
    model = build_model(conf, device=device)
    _numpy_weights(torch, model, conf.seed)
    _seed_weights(torch, model, conf.seed)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _Counted() as counted:
        ex = make_executor(conf, model, device=device)
        ex.train()
    seconds = time.perf_counter() - t0
    launches = cuda_kernels.launch_counts()
    with open(os.path.join(conf.folder, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    weights = [[float(r["val_weight_%d" % j]) for j in range(conf.n_pairs)] for r in rows]
    last = weights[-1]
    check(len(rows) == BALANCER_EPOCHS, "balancer-order: %d epochs" % len(rows))
    check(abs(sum(last) - 1.0) <= 1e-3, "balancer-order: weights sum to %.6f" % sum(last))
    check(last[0] > max(last[1:]), "balancer-order: the expert pair is not weighted first: %s"
          % last)
    if device == "cuda":
        want = counted.want(conf, image_epochs=BALANCER_EPOCHS)
        check(launches == want, "balancer-order launches %s != %s" % (launches, want))
    return {"config": "tiny", "device": str(device), "epochs": BALANCER_EPOCHS,
            "steps_per_epoch": BALANCER_STEPS, "seconds": seconds, "val_weights": weights,
            "margin_last": last[0] - max(last[1:]), "launches": launches}


def chaos_phase(torch, device, tiny=False):
    """The dress rehearsal (tools/dress_rehearsal.py) at full dafnet_chaos
    width: the 20-volume CHAOS tree fabricated at the archive's profile
    under chip_smoke_out/chaos/MR (MMSEG_TPU_CHAOS_DIR, set by main before
    the port's data modules load), the alignment table, the cold and the
    warm ingest, then the CLI with `--config dafnet_config_chaos --split 0
    --l_mix 0.5 --epochs 1` and no --dataset, capped at CHAOS_STEPS
    batches an epoch, with validation, checkpoint, export and test, then
    `--test`. Holds: every fabricated DICOM read once by the native reader,
    the loaders ChaosLoaders, and on the card the kernel launches of the
    run (2/1/3/2 a step, one round_ste a predict_mask, one tps_warp_fwd a
    def/max predict_mask)."""
    import contextlib
    import io

    from multimodal_segmentation_torch import config
    from multimodal_segmentation_torch.data.chaos import ChaosLoader
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.tools import dress_rehearsal

    argv = ["--root", CHAOS_ROOT, "--epochs", "1", "--l_mix", "0.5", "--steps-per-epoch",
            str(CHAOS_STEPS), "--device", device] + (["--tiny"] if tiny else [])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    with _Counted() as counted, contextlib.redirect_stdout(io.StringIO()):
        res = dress_rehearsal.main(argv)
    launches = cuda_kernels.launch_counts()
    run = res.pop("run")
    files = sum(sum(c) for c in dress_rehearsal.RAW_COUNTS.values())
    check(res["dicom_files"] == res["native_reads_cold"] == files,
          "DICOM files %d, native reads %d, expected %d"
          % (res["dicom_files"], res["native_reads_cold"], files))
    check(run["loader"] == ChaosLoader.__name__, "the CLI trained on %s" % run["loader"])
    steps = run["steps"]
    check(steps == 2 * CHAOS_STEPS, "steps %d != %d" % (steps, 2 * CHAOS_STEPS))
    image_epochs = sum("images" in v for v in run["epoch_seconds"].values())
    if device == "cuda":
        want = counted.want(config.dafnet_chaos(), image_epochs)
        check(launches == want, "chaos launches %s != %s" % (launches, want))
    check(all(0.0 <= d <= 1.0 for d in run["dice"].values()), "Dice %s" % run["dice"])
    out = {"config": "dafnet_chaos" if not tiny else "tiny", "device": str(device), **res,
           "cuts": {"epochs": 1, "batches_per_epoch": run["batches_per_epoch"],
                    "steps_per_epoch_cap": CHAOS_STEPS},
           **{k: run[k] for k in ("flags", "steps", "run_s", "test_s", "dice",
                                  "training_csv_last")},
           "epoch_seconds": {str(e): v for e, v in run["epoch_seconds"].items()},
           "calls": counted.n, "launches": launches}
    if device == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


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
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.train.executor import make_executor

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    flags = ["--config", preset, "--split", "0", "--l_mix", "0.5", "--dataset", "synthetic",
             "--test_dataset", "synthetic", "--device", device]
    work = os.path.join(OUT_DIR, "experiment")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def trained(conf):
        model = build_model(conf, device=device)
        _seed_weights(torch, model, conf.seed)
        ex = make_executor(conf, model, device=device)
        ex.train()
        return ex

    cwd = os.getcwd()
    counted = _Counted().__enter__()
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
            want = counted.want(conf, image_epochs)
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
        counted.__exit__()
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
        "calls": counted.n,
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


def tiny_3d():
    """cardiac_3d at the JAX tests' tiny size (tests/test_volumetric.py)."""
    from multimodal_segmentation_torch import config

    return dataclasses.replace(config.cardiac_3d(), volume_shape=(8, 32, 32, 3),
                               filters3d=4, downsample3d=2)


def _cardiac_batches(torch, conf, device):
    """The cardiac loader's split-0 training studies on `device` and an
    endless iterator over batches of conf.batch_size in the order of
    np.random.RandomState(conf.seed) permutations, the tail dropped."""
    import numpy as np

    from multimodal_segmentation_torch.data import init_loader

    xs, ys = init_loader("cardiac", shape=conf.volume_shape[:3]).load_volumes(0, "training")
    xs, ys = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    rng, B = np.random.RandomState(conf.seed), conf.batch_size

    def batches():
        while True:
            order = rng.permutation(xs.shape[0])
            for i in range(0, (xs.shape[0] // B) * B, B):
                idx = torch.from_numpy(order[i:i + B]).to(device)
                yield xs[idx], ys[idx]
    return xs.shape[0], batches()


def train3d_phase(torch, conf, device, warmup, steps, profile=0):
    """Cardiac3DSegmenter.step at `conf` on the split-0 training studies:
    `warmup` then `steps` timed steps (each with its own angles from the
    segmenter's generator): every loss finite, ms per step, studies/s,
    launches (exactly 2 nearest_warp a step and no other kernel on the
    card), peak memory, every parameter moved; then, on the card with
    `profile`, a torch.profiler window over that many steps (device time
    by kind)."""
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.ops import cuda_kernels

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    n_studies, batches = _cardiac_batches(torch, conf, device)
    model = Cardiac3DSegmenter(conf, device=device)
    params, opt = model.init(conf.seed)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    setup_s = time.perf_counter() - t0

    losses, times = [], []
    for i in range(warmup + steps):
        vb, mb = next(batches)
        if i == warmup:
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launch_counts()
        sync()
        t = time.perf_counter()
        params, opt, loss = model.step(params, opt, vb, mb)
        sync()
        dt = time.perf_counter() - t
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), "3-D loss not finite at step %d" % i)
        if i >= warmup:
            times.append(dt)
    launches = cuda_kernels.launch_counts()
    if on_card:
        want = {k: 2 * steps if k == "nearest_warp" else 0 for k in KERNEL_NAMES}
        check(launches == want, "train-3d launches %s != %s" % (launches, want))
    moved = {n: (p.detach() - before[n]).abs().max().item() for n, p in params.named_parameters()}
    check(all(v > 0 for v in moved.values()),
          "parameters did not move: %s" % [n for n, v in moved.items() if v == 0])
    ms = sorted(1e3 * t for t in times)
    p50 = ms[len(ms) // 2]
    out = {
        "config": conf.folder, "device": str(device), "batch": conf.batch_size,
        "volume": list(conf.volume_shape), "filters3d": conf.filters3d,
        "downsample3d": conf.downsample3d, "compute_dtype": conf.compute_dtype,
        "training_studies": n_studies, "setup_s": setup_s, "warmup_steps": warmup,
        "timed_steps": steps, "losses": losses, "ms_per_step": [1e3 * t for t in times],
        "p50_ms_per_step": p50, "ms_per_step_range": [ms[0], ms[-1]],
        "studies_per_s": conf.batch_size / (p50 / 1e3), "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "parameters": len(moved), "min_param_change": min(moved.values()),
    }
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if on_card and profile:
        def run():
            nonlocal params, opt
            params, opt, _ = model.step(params, opt, *next(batches))
        out["profile"] = profile_steps(torch, run, profile)
    return out


def step_grads_3d(torch, conf, device, vb, mb, th, kinks=None):
    """One Cardiac3DSegmenter.step at `conf` on `device` from init(conf.seed)
    with the given batch and angles: (loss, {parameter: gradient on the
    CPU}, {InstanceNorm3D: output}, kinks taken). With `kinks` (another
    run's norm outputs) every norm output whose sign differs from that
    run's, a value within roundoff of 0 where the ReLU after it has its
    kink, takes that run's value (its gradient path kept), so both runs
    take the same ReLU branch there."""
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.nn.unet3d import InstanceNorm3D

    model = Cardiac3DSegmenter(conf, device=device)
    params, opt = model.init(conf.seed)
    outs, taken = {}, [0]

    def hook(name):
        def f(m, i, o):
            outs[name] = o.detach().cpu()
            if kinks is None:
                return None
            ref = kinks[name].to(o.device)
            flip = (o > 0) != (ref > 0)
            taken[0] += int(flip.sum())
            return o + ((ref - o) * flip).detach()
        return f
    handles = [m.register_forward_hook(hook(n)) for n, m in params.named_modules()
               if isinstance(m, InstanceNorm3D)]
    try:
        _, _, loss = model.step(params, opt, vb.to(device), mb.to(device), th)
    finally:
        for h in handles:
            h.remove()
    return (loss.item(), {n: p.grad.float().cpu() for n, p in params.named_parameters()},
            outs, taken[0])


def train3d_cross_device_phase(torch, device):
    """The first batch of a tiny 3-D run (the tiny config's first batch
    and angles) rotated on `device` and on the CPU: bit for bit equal.
    (The step's loss and gradients on the card against the CPU's:
    tests/test_torch_gpu.py::test_tiny_3d_step_on_the_card_matches_cpu.)"""
    from multimodal_segmentation_torch.ops import augment

    conf = tiny_3d()
    _, batches = _cardiac_batches(torch, conf, device)
    vb, mb = next(batches)
    th = augment.random_rotation_angles(torch.Generator().manual_seed(conf.seed),
                                        conf.batch_size, conf.rotation_range)
    rotated = [augment.random_rotate_volumes(th.to(d), vb.to(d), mb.to(d)) for d in (device, "cpu")]
    check(all(torch.equal(a.cpu(), b) for a, b in zip(*rotated)),
          "the 3-D rotation differs between %s and the CPU" % device)
    return {"config": "tiny_3d", "device": str(device), "shape": list(vb.shape),
            "rotation_bit_equal": True}


def experiment3d_phase(torch, device, preset, **overrides):
    """The volumetric CLI: `--config <preset> --split 0 --epochs
    EXP3D_EPOCHS` (the preset has 100), then `--test` on the same folder,
    in chip_smoke_out/experiment_3d/. Checks: training.csv (an epoch a row,
    finite), models/cardiac3d.npz and test_results_cardiac/results.csv
    exist, the restored `--test` Dice within 1e-6 of the run's, and on the
    card the launches: 2 nearest_warp a step in training, none in the
    tests. Reports seconds per epoch (training, validation), the
    validation and test Dice."""
    from multimodal_segmentation_torch import experiment
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.ops import cuda_kernels

    on_card = device == "cuda"
    work = os.path.join(OUT_DIR, "experiment_3d")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    flags = ["--config", preset, "--split", "0", "--epochs", str(EXP3D_EPOCHS), "--device", device]
    step = Cardiac3DSegmenter.step
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return step(*a, **k)
    cwd = os.getcwd()
    try:
        os.chdir(work)
        Cardiac3DSegmenter.step = counted
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ex = experiment.Experiment().run(flags, **overrides)
        run_s = time.perf_counter() - t0
        launches = cuda_kernels.launch_counts()
        folder = os.path.join(work, ex.conf.folder)
        with open(os.path.join(folder, "training.csv")) as f:
            rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
        check(len(rows) == EXP3D_EPOCHS and all(math.isfinite(v) for r in rows for v in r.values()),
              "experiment-3d training.csv %s" % rows)
        for name in ("models/cardiac3d.npz", "test_results_cardiac/results.csv"):
            check(os.path.exists(os.path.join(folder, name)), "experiment-3d: no %s" % name)
        dice, n_test = _mean_dice(os.path.join(folder, "test_results_cardiac"))
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        experiment.Experiment().run(flags + ["--test"], **overrides)
        test_s = time.perf_counter() - t0
        test_launches = cuda_kernels.launch_counts()
        restored, _ = _mean_dice(os.path.join(folder, "test_results_cardiac"))
    finally:
        Cardiac3DSegmenter.step = step
        os.chdir(cwd)
    check(abs(restored - dice) <= 1e-6, "--test Dice %r != %r" % (restored, dice))
    if on_card:
        want = {k: 2 * calls[0] if k == "nearest_warp" else 0 for k in KERNEL_NAMES}
        check(launches == want, "experiment-3d launches %s != %s" % (launches, want))
        check(not any(test_launches.values()), "--test launched %s" % test_launches)
    out = {"config": ex.conf.folder, "volume": list(ex.conf.volume_shape),
           "epochs": EXP3D_EPOCHS, "steps": calls[0], "run_s": run_s, "test_s": test_s,
           "epoch_seconds": ex.epoch_seconds, "training_log": rows, "test_dice": dice,
           "test_dice_restored": restored, "test_studies": n_test,
           "launches": launches, "test_launches": test_launches}
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


# ------------------------------------------------------ data parallelism
# The phases of the port's data parallelism (parallel/). The card is one
# GPU: NCCL refuses two ranks on one device, so the two-rank phases run
# two gloo ranks on it (each collective goes through the host), and NCCL,
# the production backend, runs at world size 1 (train-dp-nccl1). Neither
# can show multi-GPU scaling.

def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def native_convolutions(torch):
    """cuDNN off inside the block: a data-parallel rank convolves fewer
    samples than the one process, and cuDNN picks another algorithm for
    another batch size, whose f32 weight gradients differ by up to 7 % of
    a leaf's largest entry (0.9 % relative L2) from the other's on the H100
    (PERF.md §6). The comparisons run PyTorch's native convolutions,
    the same for every batch size; the timed steps run cuDNN."""
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = was


def _summed(counts):
    """{kernel: launches} summed over an iterable of such dicts (ranks)."""
    out = {k: 0 for k in KERNEL_NAMES}
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return out


def dp_kernels_phase(torch, dev):
    """What the JAX package's GSPMD batch rules (pallas_kernels.py:446-594)
    promise: each kernel on the two halves of its main-path batch,
    concatenated, equals the whole call bit for bit (B1 at the training
    warp's B = 12, B2 the same, B3's three rotate_group groups of a step
    at B = 6 and its nearest_warp entry at the 3-D step's (32, 128, 128, 3),
    B4 at (12, 8, 192, 192)). B2's grad_vol adds with f32 atomics and is
    not bit-reproducible even between two whole calls: it is held to 1e-6
    of its largest entry, beside the spread of a second whole call."""
    import numpy as np

    from multimodal_segmentation_torch.ops import augment, cuda_kernels, tps

    r = np.random.RandomState(21)

    def t(*shape):
        return torch.from_numpy(r.rand(*shape).astype(np.float32)).to(dev)
    vol = t(12, 192, 192, 8)
    off = torch.from_numpy(((r.rand(12, 25, 2) - 0.5) * 0.3).astype(np.float32)).to(dev)
    wv, cp = tps.tps_coefficients(off), tps.control_grid((5, 5), dev)
    locs = tps.tps_sample_locations(off, (192, 192)).contiguous()
    g = torch.from_numpy(r.randn(12, 192, 192, 8).astype(np.float32)).to(dev)
    groups = [[t(6, 192, 192, c) for c in widths] for widths in ((1, 1, 4, 4), (4, 4), (1, 1))]
    th = torch.from_numpy(r.uniform(-0.35, 0.35, 6).astype(np.float32)).to(dev)
    v3 = t(32, 128, 128, 3)
    th3 = torch.from_numpy(r.uniform(-0.35, 0.35, 32).astype(np.float32)).to(dev)
    x = t(12, 8, 192, 192)
    calls = {
        "tps_warp_fwd (12, 192, 192, 8)": lambda s: [cuda_kernels.tps_warp_fwd(vol[s], wv[s], cp)],
        "tps_warp_bwd (12, 192, 192, 8)": lambda s: list(cuda_kernels.tps_warp_bwd(
            vol[s], locs[s], g[s])),
        "rotate_group (6, 192, 192, 1+1+4+4 | 4+4 | 1+1)": lambda s: [
            o for grp in groups for o in cuda_kernels.rotate_group(
                [a[s].contiguous() for a in grp], torch.cos(th[s]), torch.sin(th[s]))],
        "nearest_warp (32, 128, 128, 3)": lambda s: [cuda_kernels.nearest_warp(
            v3[s].contiguous(), augment.rotation_locations(th3[s], 128, 128))],
        "round_ste (12, 8, 192, 192)": lambda s: [cuda_kernels.round_ste(x[s].contiguous())],
    }
    out = {}
    for name, call in calls.items():
        whole = call(slice(None))
        n = whole[0].shape[0] // 2
        halves = [call(slice(0, n)), call(slice(n, None))]
        again = call(slice(None))
        torch.cuda.synchronize()
        row = {"outputs": len(whole)}
        for k, w in enumerate(whole):
            cat = torch.cat([halves[0][k], halves[1][k]])
            if name.startswith("tps_warp_bwd") and k == 0:
                # grad_vol sums with f32 atomics in an order that changes
                # from run to run (csrc/tps_warp_bwd.cu): the halves must
                # lie within that spread, a few ulp of its largest entry
                top = w.abs().max().item()
                row["grad_vol_halves_max_diff_over_max"] = (cat - w).abs().max().item() / top
                row["grad_vol_rerun_max_diff_over_max"] = (again[k] - w).abs().max().item() / top
                check(row["grad_vol_halves_max_diff_over_max"] <= 1e-6,
                      "dp-kernels: %s grad_vol on the halves differs by %.3g of its max"
                      % (name, row["grad_vol_halves_max_diff_over_max"]))
            else:
                check(torch.equal(cat, w) and torch.equal(again[k], w),
                      "dp-kernels: %s output %d on the halves differs from the whole call"
                      % (name, k))
        row["bit_exact"] = "all outputs" if len(whole) == 1 or not name.startswith(
            "tps_warp_bwd") else "grad_locs (grad_vol within the atomics' spread)"
        out[name] = row
    return out


def dp_train_steps(torch, conf, device, mesh, compared, timed, min_features=None):
    """DAFNetSteps.step_supervised at `conf` from build_model's weights on
    the executor's batches (global arrays; under `mesh` this
    rank's rows, shard_batch), the noise drawn from the train state's
    generator at the global batch: the metrics of the first `compared`
    steps (on native convolutions), the generator's gradients of the first
    (as its Adam gets them) and the state after them (on the CPU), then
    `timed` more steps: their ms, p50, launches and peak memory. With
    `min_features` the train state is sharded over the mesh's 'model' axis
    (tp_shard_train_state); the gradients and the state are then gathered
    whole (every rank takes part), and the bytes of the weights the
    forward gathers a step are counted."""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.data.batches import TrainingData
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.parallel import collectives, shard_batch
    from multimodal_segmentation_torch.parallel import sharding
    from multimodal_segmentation_torch.train import create_train_state, make_steps

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    loader = init_loader("synthetic", hw=conf.input_hw)
    loader.modalities = list(conf.modality)
    # the weights build_model draws, where training starts: with the slice's
    # seeded weights (_seed_weights, a sharper anatomy head) the anatomy
    # logits of a rank and of the one process differ by ~1e-4 of their
    # size (the other order of the BatchNorm sums, cuDNN's algorithm for
    # another batch size), an anatomy value rounds the other way and the
    # TPS warp's gradient moves by ~30 % (PERF.md §6); at this init
    # the logits are small and agree far inside the anatomy values'
    # distance from 0.5 (both reported)
    model = build_model(conf, device=device)
    near_half, logits = [], []

    def seen(m, i, o):
        near_half.append((torch.softmax(o.detach().float(), 1) - 0.5).abs().min().item())
        if not logits:
            logits.append(o.detach().float().cpu())
    hook = model.enc_anatomy.conv_anatomy.register_forward_hook(seen)
    steps = make_steps(model, conf, mesh)
    ts = create_train_state(model, conf)
    sharded = {}
    if min_features is not None:
        sharding.tp_shard_train_state(mesh, ts, min_features)
        sharded = {n: tuple(p.shape) for n, p in sharding.sharded_parameters(model).items()}
    batches = TrainingData(conf, loader).assembled_batches()
    metrics, times, state = [], [], None
    # the generator's gradients of the first step, as its Adam gets them
    # (after the mesh's reduction), each sharded leaf gathered whole
    names = {id(p): n for n, p in model.named_parameters()}
    grads1, opt_step = {}, ts.opt_gen.step

    def first_step(*a, **k):
        for p in ts.opt_gen.param_groups[0]["params"]:
            grads1[names[id(p)]] = sharding.whole_named(
                model, {names[id(p)]: p.grad.detach()})[names[id(p)]].cpu().clone()
        ts.opt_gen.step = opt_step
        return opt_step(*a, **k)
    ts.opt_gen.step = first_step

    def whole_state():
        return {k: v.detach().cpu().clone()
                for k, v in sharding.whole_named(model, model.state_dict()).items()}

    def replicated_state():
        # this rank's copy of every leaf that 'model' does not shard
        if min_features is None:
            return None
        return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                if k not in sharded}
    gathered = [0]
    gather = collectives.gather

    def counted_gather(x, dim, axis):
        out = gather(x, dim, axis)
        gathered[0] += out.numel() * out.element_size()
        return out
    collectives.gather = counted_gather
    cuda_kernels.reset_launch_counts()
    for i in range(compared + timed):
        batch = next(batches)["sup"]
        if mesh is not None:
            batch = shard_batch(mesh, batch, device)
        if i == compared:
            state, replicated = whole_state(), replicated_state()
            budget = adam_budget(model, ts)
            cuda_kernels.reset_launch_counts()
            gathered[0] = 0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
        sync()
        t = time.perf_counter()
        with native_convolutions(torch) if i < compared else contextlib.nullcontext():
            ts, m = steps.step_supervised(ts, batch)
        sync()
        if i >= compared:
            times.append(time.perf_counter() - t)
        m = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in m.values()), "non-finite metric: %s" % m)
        if i < compared:
            metrics.append(m)
        if i == 0:
            hook.remove()
    collectives.gather = gather
    launches = cuda_kernels.launch_counts()
    if state is None:
        state, replicated = whole_state(), replicated_state()
        budget = adam_budget(model, ts)
    ms = sorted(1e3 * t for t in times)
    out = {"metrics": metrics, "state": state, "budget": budget, "grads1": grads1,
           "min_anatomy_distance_from_half_step1": min(near_half),
           "anatomy_logits_step1": logits[0],
           "launches": launches, "steps_counted": timed,
           "ms_per_step": [1e3 * t for t in times],
           "p50_ms_per_step": ms[len(ms) // 2] if ms else None,
           "biases_ahead_of_batchnorm": sorted(_biases_ahead_of_batchnorm(model))}
    if on_card and timed:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if min_features is not None:
        out.update(sharded_shapes=sharded, replicated_state=replicated,
                   gathered_bytes_per_step=gathered[0] / max(timed, 1))
    return out


def adam_budget(model, ts):
    """{parameter name: sum over the Adams that update it of lr x their
    steps so far}: how far Adam can have moved it (about lr a step), and
    so how far two runs can part where a gradient entry is near 0."""
    names = {id(p): n for n, p in model.named_parameters()}
    opts = [ts.opt_gen, *ts.opt_disc.values()] + ([ts.opt_zreg] if ts.opt_zreg else [])
    out = {}
    for opt in opts:
        lr = opt.param_groups[0]["lr"]
        for p, st in opt.state.items():
            out[names[id(p)]] = out.get(names[id(p)], 0.0) + lr * float(st["step"])
    return out


def _biases_ahead_of_batchnorm(model):
    """The bias of every conv that feeds a BatchNorm (Conv_k -> Norm_k or
    BatchNorm_k in one module): gradient 0 in exact arithmetic."""
    from multimodal_segmentation_torch.nn.blocks import BatchNorm, Conv2d

    names = set()
    for prefix, m in model.named_modules():
        for child_name, child in m.named_children():
            if isinstance(child, BatchNorm):
                k = child_name.rsplit("_", 1)[1]
                conv = getattr(m, "Conv_" + k, None)
                if isinstance(conv, Conv2d) and conv.bias is not None:
                    names.add((prefix + "." if prefix else "") + "Conv_%s.bias" % k)
    return names


def dp_state_gap(got, ref, biases, budget, buffer_rel=None):
    """Parameters and buffers of a run against another, from the same
    start: the largest difference of a parameter entry over its Adam
    budget (adam_budget; the biases ahead of a BatchNorm and the rest
    apart), the largest of a buffer (BatchNorm statistics, spectral u)
    relative to its leaf's largest entry, and the share of entries off by
    more than 1e-5 of their leaf's largest entry plus 0.05 of the budget.
    Integer buffers must be equal; with `buffer_rel`, each buffer within
    that share of its leaf's largest entry plus 0.02 of the smallest
    budget (a running mean takes 0.01 of its conv bias's difference)."""
    worst = {"max_over_budget_biases_ahead_of_batchnorm": 0.0, "max_over_budget_other": 0.0,
             "max_rel_buffers": 0.0, "share_past_1e-5_rel": 0.0, "entries": 0}
    past, least = 0, min(budget.values())
    for k, r in ref.items():
        if not r.is_floating_point():
            check(got[k].equal(r), "dp state %s differs" % k)
            continue
        diff = (got[k] - r).abs()
        d, b, top = diff.max().item(), budget.get(k, least), r.abs().max().item()
        if k in budget:
            key = ("max_over_budget_biases_ahead_of_batchnorm" if k in biases
                   else "max_over_budget_other")
            worst[key] = max(worst[key], d / b)
        else:
            worst["max_rel_buffers"] = max(worst["max_rel_buffers"], d / top if top else d)
            if buffer_rel is not None:
                check(d <= buffer_rel * top + 0.02 * least, "dp buffer %s differs by %.3g "
                      "(largest entry %.3g, limit %.3g relative)" % (k, d, top, buffer_rel))
        past += int((diff > 1e-5 * top + 0.05 * b).sum())
        worst["entries"] += r.numel()
    worst["share_past_1e-5_rel"] = past / max(worst["entries"], 1)
    return worst


def dp_grads_gap(got, ref, biases):
    """The largest relative difference of a gradient leaf (its largest
    difference over its largest entry), the biases ahead of a BatchNorm
    (gradient 0 in exact arithmetic) apart, over the largest gradient."""
    top = max(g.abs().max().item() for g in ref.values())
    other, leaf = max(((got[n] - g).abs().max().item() / g.abs().max().item(), n)
                      for n, g in ref.items() if n not in biases and g.abs().max().item() > 0)
    zero = max((got[n] - ref[n]).abs().max().item() for n in biases if n in ref) / top
    diff = sum((got[n] - g).double().square().sum().item() for n, g in ref.items())
    norm = sum(g.double().square().sum().item() for g in ref.values())
    return {"max_rel": other, "worst_leaf": leaf, "rel_l2": math.sqrt(diff / norm),
            "biases_ahead_of_batchnorm_over_top": zero}


def dp_check_against(name, got, ref, rerun, rank=0):
    """Hold a data-parallel run (`got`: dp_train_steps' result) to the one
    process (`ref`), with the one process's rerun (`rerun`: the same start
    again) as the yardstick of what the card itself does not reproduce
    (B2 adds with f32 atomics; Adam turns roundoff at gradient entries
    near 0 into steps of up to lr). `rank`: got's rows are the rank-th
    slice of the batch.

    Before any update: the first forward's anatomy logits are compared
    and their rounding flips counted; without a flip the first step's
    generator metrics agree within 1e-5; its generator gradients within
    2e-2 relative L2, or 10 times the rerun's gap: a rank's forward sums
    in another order, so ReLU and max-pool decisions within roundoff of a
    tie go the other way and route their gradient elsewhere (in the 3-D
    phase such kinks are aligned; here they are many): 1.1e-4 in the tiny
    CPU rehearsal, 4.9e-3 (leaf max 3.1e-2) at full width on the H100
    (PERF.md §6), where two runs with one forward differ by 1.2e-6.
    After the
    update: every parameter entry within twice its Adam budget; at most
    0.5 % of the entries, or 3 times the rerun's share, past 1e-5 of their
    leaf; each buffer within 2e-3 of its leaf, or 10 times the rerun's gap
    (dp_state_gap); the metrics that see the updated generator (the
    discriminators') within 1e-2 or 10 times the rerun's gap: on the card
    the reruns and the mesh of one rank already differ there by 4.5e-4 to
    3.5e-3 (tests/test_torch_dafnet_train.py holds the port to 2e-3 of JAX
    on the CPU). Returns the gaps."""
    biases = set(ref["biases_ahead_of_batchnorm"])
    # the first forward's anatomy logits (the dual encoder's, both
    # modalities interleaved): this run's rows of the reference's
    a = got["anatomy_logits_step1"]
    part = ref["anatomy_logits_step1"][rank * a.shape[0]:(rank + 1) * a.shape[0]]
    flips = int(((a.softmax(1) > 0.5) != (part.softmax(1) > 0.5)).sum())
    spread = {"metric_rel_diff_by_step": dp_metrics_gap(rerun["metrics"], ref["metrics"]),
              "step1_generator_grads": dp_grads_gap(rerun["grads1"], ref["grads1"], biases),
              "state": dp_state_gap(rerun["state"], ref["state"], biases, ref["budget"])}
    buffer_rel = max(2e-3, 10 * spread["state"]["max_rel_buffers"])
    out = {"anatomy_logits_step1_max_diff": (a - part).abs().max().item(),
           "anatomy_rounding_flips_step1": flips,
           "metric_rel_diff_by_step": dp_metrics_gap(got["metrics"], ref["metrics"]),
           "step1_generator_grads": dp_grads_gap(got["grads1"], ref["grads1"], biases),
           "state": dp_state_gap(got["state"], ref["state"], biases, ref["budget"], buffer_rel)}
    for i, (g, r) in enumerate(zip(out["metric_rel_diff_by_step"],
                                   spread["metric_rel_diff_by_step"])):
        for kind in g:
            tight = i == 0 and kind == "generator" and not flips
            lim = 1e-5 if tight else max(1e-2, 10 * r[kind])
            check(g[kind] <= lim, "%s: step %d %s metrics differ by %.3g (limit %.3g): %s vs %s"
                  % (name, i, kind, g[kind], lim, got["metrics"][i], ref["metrics"][i]))
    g, r = out["step1_generator_grads"], spread["step1_generator_grads"]
    lim = max(2e-2, 10 * r["rel_l2"])
    check(g["rel_l2"] <= lim, "%s: first-step gradients differ by %.3g (relative L2, limit "
          "%.3g): %s; the rerun's %s" % (name, g["rel_l2"], lim, out, r))
    g, r = out["state"], spread["state"]
    for key in ("max_over_budget_biases_ahead_of_batchnorm", "max_over_budget_other"):
        # two Adam steps of opposite sign, each under lr, plus the
        # parameter's own f32 rounding
        check(g[key] <= 2.001, "%s: %s %.6g" % (name, key, g[key]))
    lim = max(5e-3, 3 * r["share_past_1e-5_rel"])
    check(g["share_past_1e-5_rel"] <= lim, "%s: %.3g of the entries past 1e-5 (limit %.3g)"
          % (name, g["share_past_1e-5_rel"], lim))
    out["one_process_rerun"] = spread
    return out


def dp_metrics_gap(got, ref):
    """The largest relative difference of the metrics of a run from
    another's, step by step: [{'generator': x, 'discriminators': y}, ...]."""
    out = []
    for g, r in zip(got, ref, strict=True):
        check(sorted(g) == sorted(r), "dp metric names %s != %s" % (sorted(g), sorted(r)))
        gaps = {"generator": 0.0, "discriminators": 0.0}
        for k in r:
            rel = abs(g[k] - r[k]) / abs(r[k]) if r[k] else abs(g[k])
            kind = "discriminators" if k.startswith("dis_") else "generator"
            gaps[kind] = max(gaps[kind], rel)
        out.append(gaps)
    return out


def train_dp_nccl1_phase(torch, conf, device, compared, timed):
    """An NCCL process group of world size 1 in this process and a
    data = 1 mesh: the full-width expert step through the mesh code against
    the mesh-free step on the same card, from the same weights, batches and
    noise. An all-reduce of one rank is a copy, BatchNorm averages one
    rank's moments (divided by 1), the gradients are divided by 1: the
    first step's forward, and so its generator metrics, must equal the
    mesh-free run's bit for bit. The rest need not: two mesh-free runs
    already differ (dp_check_against), so a second mesh-free run is the
    yardstick. Launches exact in both. Returns (row, the mesh-free run,
    its rerun) for train-dp."""
    import torch.distributed as dist

    from multimodal_segmentation_torch.parallel import make_mesh

    alone = dp_train_steps(torch, conf, device, None, compared, timed)
    again = dp_train_steps(torch, conf, device, None, compared, 0)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://localhost:%d" % _free_port(),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        meshed = dp_train_steps(torch, conf, device, mesh, compared, timed)
        used = dist.get_backend(mesh.axis("data").group)
    finally:
        dist.destroy_process_group()
    first = {k: v for k, v in alone["metrics"][0].items() if not k.startswith("dis_")}
    check(all(meshed["metrics"][0][k] == v for k, v in first.items()),
          "nccl1: the first step's generator metrics differ: %s vs %s"
          % (meshed["metrics"][0], alone["metrics"][0]))
    gaps = dp_check_against("train-dp-nccl1", meshed, alone, again)
    want = {k: v * timed for k, v in launches_per_batch(conf).items()}
    if device == "cuda":
        for run in (alone, meshed):
            check(run["launches"] == want, "nccl1 launches %s != %s" % (run["launches"], want))
    row = {"backend": used, "world_size": 1, "batch": conf.batch_size,
           "compared_steps": compared, "first_step_generator_metrics_bit_equal": True, **gaps,
           "min_anatomy_distance_from_half_step1": alone["min_anatomy_distance_from_half_step1"],
           "launches": meshed["launches"], "timed_steps": timed,
           "p50_ms_per_step_mesh": meshed["p50_ms_per_step"],
           "p50_ms_per_step_mesh_free": alone["p50_ms_per_step"],
           "ms_per_step_mesh": meshed["ms_per_step"],
           "ms_per_step_mesh_free": alone["ms_per_step"]}
    return row, alone, again


def remat_runs(torch, conf, device, timed):
    """MMSDNet batches at `conf` from build_model's weights on the
    executor's batches (a supervised generator step with its Z-regressor
    update, then a discriminator step, the noise from the train state's
    generator): the first on native convolutions (as the data-parallel
    comparisons, native_convolutions), its metrics and the state after
    it; then `timed` batches: ms, p50, launches, peak memory."""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.data.batches import TrainingData
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.train import create_train_state, make_steps

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    loader = init_loader("synthetic", hw=conf.input_hw)
    loader.modalities = list(conf.modality)
    model = build_model(conf, device=device)
    steps = make_steps(model, conf)
    ts = create_train_state(model, conf)
    batches = TrainingData(conf, loader).assembled_batches()
    times, first = [], None
    for i in range(1 + timed):
        batch = next(batches)
        if i == 1:
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            budget = adam_budget(model, ts)
            cuda_kernels.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
        sync()
        t = time.perf_counter()
        with native_convolutions(torch) if i == 0 else contextlib.nullcontext():
            ts, m = steps.step_supervised(ts, batch["sup"])
            ts, d = steps.step_discriminator(ts, batch["disc"])
        sync()
        m = {k: float(v) for k, v in {**m, **d}.items()}
        check(all(math.isfinite(v) for v in m.values()), "non-finite metric: %s" % m)
        if i == 0:
            first = m
        else:
            times.append(time.perf_counter() - t)
    ms = sorted(1e3 * t for t in times)
    return {"metrics": [first], "state": state, "budget": budget,
            "launches": cuda_kernels.launch_counts(), "ms_per_step": [1e3 * t for t in times],
            "p50_ms_per_step": ms[len(ms) // 2],
            "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None,
            "biases_ahead_of_batchnorm": sorted(_biases_ahead_of_batchnorm(model))}


def remat_phase(torch, device, presets, timed):
    """MMSDNet with remat_convs (nn/blocks.py::remat) against without, at
    each of `presets` ({name: conf}), f32 and bf16: one run with remat, one
    without and a second one without (the card's own run-to-run gap, B2's
    atomics), each a compared batch and `timed` timed ones. The first
    batch's generator metrics (computed before any update) equal the run
    without remat to 1e-6 relative; the Z-regressor's and the
    discriminator's, which see the updated generator, within 1e-2 or 10
    times the rerun's gap; the state after it as dp_check_against holds
    it (parameters within twice their Adam budget; each buffer within 2e-3
    of its leaf or 10 times the rerun's gap: a running statistic updated
    twice would be off by ~1 % of its value). Launches exact (3/1/3/6 a
    batch: remat recomputes no kernel of the port). Reports the peak
    memory of each setting, the reason remat exists, and p50 ms."""
    rows = {}
    for name, conf in presets.items():
        runs = {}
        for key, remat in (("plain", False), ("rerun", False), ("remat", True)):
            runs[key] = remat_runs(torch, dataclasses.replace(conf, remat_convs=remat),
                                   device, timed)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        plain, rerun, remat = runs["plain"], runs["rerun"], runs["remat"]
        biases = set(plain["biases_ahead_of_batchnorm"])
        spread = dp_state_gap(rerun["state"], plain["state"], biases, plain["budget"])
        buffer_rel = max(2e-3, 10 * spread["max_rel_buffers"])
        gap = dp_state_gap(remat["state"], plain["state"], biases, plain["budget"], buffer_rel)
        for key in ("max_over_budget_biases_ahead_of_batchnorm", "max_over_budget_other"):
            check(gap[key] <= 2.001, "remat %s: %s %.6g" % (name, key, gap[key]))
        lim = max(5e-3, 3 * spread["share_past_1e-5_rel"])
        check(gap["share_past_1e-5_rel"] <= lim, "remat %s: %.3g of the entries past 1e-5"
              % (name, gap["share_past_1e-5_rel"]))
        after_update = ("rec_Z", "dis_M")
        m_gap, m_spread = {}, {}
        for k, v in plain["metrics"][0].items():
            m_gap[k] = abs(remat["metrics"][0][k] - v) / max(abs(v), 1e-30)
            m_spread[k] = abs(rerun["metrics"][0][k] - v) / max(abs(v), 1e-30)
            lim = max(1e-2, 10 * m_spread[k]) if k in after_update else 1e-6
            check(m_gap[k] <= lim, "remat %s: first batch %s differs by %.3g (limit %.3g)"
                  % (name, k, m_gap[k], lim))
        if torch.device(device).type == "cuda":
            want = {k: v * timed for k, v in launches_per_batch(conf).items()}
            for key, run in runs.items():
                check(run["launches"] == want, "remat %s %s launches %s" % (name, key,
                                                                            run["launches"]))
        rows[name] = {
            "compute_dtype": conf.compute_dtype, "batch": conf.batch_size,
            "first_batch_metric_rel_diff": m_gap, "rerun_metric_rel_diff": m_spread,
            "state": gap, "rerun_state": spread,
            "max_memory_allocated": {k: r["max_memory_allocated"] for k, r in runs.items()},
            "memory_remat_over_plain": (remat["max_memory_allocated"] /
                                        plain["max_memory_allocated"]
                                        if plain["max_memory_allocated"] else None),
            "p50_ms_per_step": {k: r["p50_ms_per_step"] for k, r in runs.items()},
            "ms_per_step": {k: r["ms_per_step"] for k, r in runs.items()},
            "timed_steps": timed, "launches": remat["launches"],
        }
    return rows


def dp_3d_reference(torch, conf, device):
    """The unsharded 3-D step of train-3d-dp: the first batch and angles,
    the loss, the gradients and the InstanceNorm3D outputs (step_grads_3d)."""
    from multimodal_segmentation_torch.ops import augment

    _, batches = _cardiac_batches(torch, conf, "cpu")
    vb, mb = next(batches)
    th = augment.random_rotation_angles(torch.Generator().manual_seed(conf.seed),
                                        conf.batch_size, conf.rotation_range)
    with native_convolutions(torch):
        loss, grads, outs, _ = step_grads_3d(torch, conf, device, vb, mb, th)
    return {"vb": vb, "mb": mb, "th": th, "loss": loss, "grads": grads, "norms": outs}


def dp_3d_rank(torch, conf, device, shape, ref, timed):
    """On a ('data', 'space') mesh of `shape`: one Cardiac3DSegmenter.step
    from init(conf.seed) on this rank's part of the reference batch with
    the global angles, each InstanceNorm3D output that lies on the other
    side of 0 from the unsharded run's taking that run's value (so the
    ReLU after it takes its branch; the count is kept): the loss and the
    gradients after the mesh's reduction; then `timed` more steps on the
    same batch with fresh angles: ms, p50, launches."""
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.nn.unet3d import InstanceNorm3D
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.parallel import Mesh
    from multimodal_segmentation_torch.parallel.collectives import halo_transport

    mesh = Mesh(("data", "space"), shape)
    d, s = mesh.axis("data"), mesh.axis("space")
    model = Cardiac3DSegmenter(conf, device=device, mesh=mesh)
    params, opt = model.init(conf.seed)
    kinks = [0]

    def hook(name):
        def f(m, i, o):
            t = ref["norms"][name]
            b, k = t.shape[0] // d.size, t.shape[2] // s.size
            t = t[d.index * b:(d.index + 1) * b, :, s.index * k:(s.index + 1) * k].to(o.device)
            flip = (o > 0) != (t > 0)
            kinks[0] += int(flip.sum())
            return o + ((t - o) * flip).detach()
        return f
    handles = [m.register_forward_hook(hook(n)) for n, m in params.named_modules()
               if isinstance(m, InstanceNorm3D)]
    vb, mb = model.shard_batch((ref["vb"], ref["mb"]))
    try:
        with native_convolutions(torch):
            _, _, loss = model.step(params, opt, vb, mb, ref["th"])
    finally:
        for h in handles:
            h.remove()
    grads = {n: p.grad.float().cpu() for n, p in params.named_parameters()}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    cuda_kernels.reset_launch_counts()
    times = []
    for _ in range(timed):
        sync()
        t0 = time.perf_counter()
        params, opt, l = model.step(params, opt, vb, mb)
        sync()
        times.append(time.perf_counter() - t0)
        check(math.isfinite(l.item()), "train-3d-dp loss not finite")
    ms = sorted(1e3 * t for t in times)
    return {"mesh": {"data": shape[0], "space": shape[1]}, "loss": loss.item(), "grads": grads,
            "kinks": kinks[0], "launches": cuda_kernels.launch_counts(), "steps_counted": timed,
            "halo": halo_transport(s, device) if s.size > 1 else None,
            "ms_per_step": [1e3 * t for t in times], "p50_ms_per_step": ms[len(ms) // 2]}


def dp_experiment(torch, conf, device, mesh):
    """The DAFNet executor (train, then test) at `conf`, alone or on
    `mesh`: the final epoch and step, the early stop epoch, the SWA
    weights (on the CPU), training.csv, how many times this process wrote
    each kind of file, and the kernel launches with what the counted calls
    should have launched."""
    from multimodal_segmentation_torch.eval.tester import ModelTester
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.ops import cuda_kernels
    from multimodal_segmentation_torch.train.executor import make_executor
    from multimodal_segmentation_torch.utils import observability
    from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager

    writes, saved = {}, []
    for cls, name in ((CheckpointManager, "save"), (CheckpointManager, "save_component_weights"),
                      (observability.LossLogger, "on_epoch_end"),
                      (observability.TrainingImageCallback, "on_epoch_end"),
                      (ModelTester, "run")):
        fn = getattr(cls, name)
        saved.append((cls, name, fn))

        def wrapper(*a, _fn=fn, _key=cls.__name__ + "." + name, **k):
            writes[_key] = writes.get(_key, 0) + 1
            return _fn(*a, **k)
        setattr(cls, name, wrapper)
    counted = _Counted().__enter__()
    try:
        cuda_kernels.reset_launch_counts()
        model = build_model(conf, device=device)
        ex = make_executor(conf, model, device=device, mesh=mesh)
        with native_convolutions(torch):
            ts = ex.train()
            ex.test()
        launches = cuda_kernels.launch_counts()
    finally:
        counted.__exit__()
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    with open(os.path.join(conf.folder, "training.csv")) as f:
        rows = list(csv.DictReader(f)) if (mesh is None or mesh.rank == 0) else None
    images = writes.get("TrainingImageCallback.on_epoch_end", 0)
    return {"epoch": ts.epoch, "step": ts.step, "stopped_epoch": ex.early_stopping.stopped_epoch,
            "swa": {k: v.detach().cpu().clone() for k, v in ts.swa.items()},
            "budget": adam_budget(model, ts),
            "training_csv": rows, "writes": writes, "launches": launches,
            "launches_want": counted.want(conf, images),
            "biases_ahead_of_batchnorm": sorted(_biases_ahead_of_batchnorm(model))}


def fused_adam_phase(torch, conf, device, alone, again):
    """The full-width expert step with fused_adam (one fused Adam update
    an optimizer, train/state.py::adam) against the per-leaf Adam
    (`alone`, train-dp-nccl1's mesh-free run, with `again` its rerun as
    the yardstick, dp_check_against): the first step compared, then
    FUSED_TIMED timed; ms a step of each. Launches exact."""
    fused = dp_train_steps(torch, dataclasses.replace(conf, fused_adam=True), device, None,
                           DP_COMPARED, FUSED_TIMED)
    gaps = dp_check_against("fused-adam", fused, alone, again)
    if device == "cuda":
        want = {k: v * FUSED_TIMED for k, v in launches_per_batch(conf).items()}
        check(fused["launches"] == want, "fused-adam launches %s" % fused["launches"])
    return {"batch": conf.batch_size, "compared_steps": DP_COMPARED, "timed_steps": FUSED_TIMED,
            **gaps, "launches": fused["launches"],
            "p50_ms_per_step_fused": fused["p50_ms_per_step"],
            "ms_per_step_fused": fused["ms_per_step"],
            "p50_ms_per_step_per_leaf": alone["p50_ms_per_step"],
            "ms_per_step_per_leaf": alone["ms_per_step"]}


def train_tp_rows(res, alone, again, conf, device, min_features, leaves):
    """train-tp: each of the two gloo ranks of a (1, 2) mesh ran the
    full-width expert step with the train state sharded at
    `min_features` (dp_train_steps), each over the whole batch. Each
    rank holds `leaves` sharded leaves, half of each; its first step's
    generator metrics equal the mesh-free run's (`alone`) bit for bit
    (both compute the unsharded forward on the same card, the weights
    gathered exactly); the rest as dp_check_against holds it against the
    mesh-free run's own rerun. The leaves that 'model' replicates are
    equal on the two ranks (parameters bit for bit: their gradients are
    averaged over 'model'; BatchNorm statistics, spectral u: their largest
    difference reported, within 1e-6 of the leaf). Launches 2/1/3/2 a step
    a rank. One card: a correctness phase, not a scaling figure."""
    per_rank = []
    want = {k: v * TP_TIMED for k, v in launches_per_batch(conf).items()}
    first = {k: v for k, v in alone["metrics"][0].items() if not k.startswith("dis_")}
    for rank, r in enumerate(res):
        t = r["train-tp"]
        check(len(t["sharded_shapes"]) == leaves, "train-tp rank %d holds %d sharded leaves"
              % (rank, len(t["sharded_shapes"])))
        for n, shape in t["sharded_shapes"].items():
            whole = tuple(alone["state"][n].shape)
            check(shape == (whole[0] // 2,) + whole[1:], "train-tp %s: %s of %s" % (n, shape,
                                                                                   whole))
        check(all(t["metrics"][0][k] == v for k, v in first.items()),
              "train-tp rank %d: the first step's generator metrics differ: %s vs %s"
              % (rank, t["metrics"][0], alone["metrics"][0]))
        gaps = dp_check_against("train-tp rank %d" % rank, t, alone, again)
        spread = gaps.pop("one_process_rerun")
        if device == "cuda":
            check(t["launches"] == want, "train-tp rank %d launches %s" % (rank, t["launches"]))
        per_rank.append({"rank": rank, **gaps, "launches": t["launches"],
                         "p50_ms_per_step": t["p50_ms_per_step"], "ms_per_step": t["ms_per_step"],
                         "max_memory_allocated": t.get("max_memory_allocated"),
                         "gathered_bytes_per_step": t["gathered_bytes_per_step"]})
    a, b = (r["train-tp"]["replicated_state"] for r in res)
    params = set(alone["budget"])
    check(all(a[k].equal(b[k]) for k in a if k in params),
          "train-tp: a replicated parameter differs between the model ranks")
    buffers = {k: (a[k].float() - b[k].float()).abs().max().item() /
               max(b[k].float().abs().max().item(), 1e-30)
               for k in a if k not in params and a[k].is_floating_point()}
    worst = max(buffers.values())
    check(worst <= 1e-6, "train-tp: buffers differ between the model ranks by %.3g" % worst)
    sharded = res[0]["train-tp"]["sharded_shapes"]
    return {"backend": res[0]["backend"], "mesh": {"data": 1, "model": 2}, "ranks": 2,
            "cards": 1, "batch": conf.batch_size, "min_features": min_features,
            "sharded_leaves": len(sharded),
            "sharded_parameters": 2 * sum(math.prod(s) for s in sharded.values()),
            "parameters": sum(v.numel() for k, v in alone["state"].items() if k in params),
            "compared_steps": DP_COMPARED, "timed_steps": TP_TIMED,
            "first_step_generator_metrics_bit_equal": True,
            "replicated_parameters_equal_across_model": True,
            "buffers_max_rel_diff_across_model": worst,
            "p50_ms_per_step_mesh_free": alone["p50_ms_per_step"],
            "max_memory_allocated_mesh_free": alone.get("max_memory_allocated"),
            "note": "two gloo ranks on one card: the weight gathers go through the host; "
                    "a correctness phase, not a scaling figure",
            "one_process_rerun": spread, "per_rank": per_rank}


def dp_experiment_conf(folder):
    """The tiny config, 3 epochs of 2 steps, early stopping set to fire at
    epoch 1 (a loss must fall by 10 to count), on the synthetic data.
    training.csv is held to 1e-3 relative, or to 10 times a second one
    process run's own difference, whichever is larger: its epoch means
    take in steps after updates, where Adam's lr-sized differences at
    gradient entries near 0 move the discriminator metrics (2.6e-5 on the
    H100, PERF.md §6; 2.7e-7 on the CPU); the SWA weights as
    dp_check_against holds the state."""
    from multimodal_segmentation_torch import config

    return dataclasses.replace(config.tiny_test_config(), dataset_name="synthetic",
                               test_dataset="synthetic", steps_per_epoch=2, epochs=3,
                               es_patience=1, es_min_delta=10.0, folder=folder)


def dp_rank(rank, port, work, device, conf2d, conf3d, shapes3d, tp_min_features):
    """One of the two gloo ranks of train-dp, train-tp, train-3d-dp and
    experiment-dp (started by dp_phases with torch.multiprocessing): joins
    the group, runs the four phases' rank parts and saves its results to
    work/rank<r>.pt. An exception ends the process with a non-zero code."""
    import datetime

    import torch
    import torch.distributed as dist

    from multimodal_segmentation_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port, world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=600))
    try:
        out = {"backend": dist.get_backend()}
        out["train-dp"] = dp_train_steps(torch, conf2d, device, make_mesh(2), DP_COMPARED,
                                         DP_TIMED)
        out["train-tp"] = dp_train_steps(torch, conf2d, device, make_mesh(1, 2), DP_COMPARED,
                                         TP_TIMED, min_features=tp_min_features)
        ref3d = torch.load(os.path.join(work, "ref3d.pt"), weights_only=False)
        out["train-3d-dp"] = [dp_3d_rank(torch, conf3d, device, s, ref3d, DP_TIMED)
                              for s in shapes3d]
        del ref3d
        exp_conf = dp_experiment_conf(os.path.join(work, "experiment_dp"))
        out["experiment-dp"] = dp_experiment(torch, exp_conf, device, make_mesh(2))
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(work, "rank%d.pt" % rank))


def dp_phases(torch, device, conf2d, conf3d, tp):
    """train-dp-nccl1 and fused-adam, then train-dp, train-tp, train-3d-dp
    and experiment-dp: the references in this process, then two gloo ranks
    (one spawned process each, the kernels already built) for the last
    four at once. Yields (phase, row) as each is checked; `tp`: train-tp's
    (min_features, sharded leaves)."""
    import torch.multiprocessing as mp

    work = os.path.join(OUT_DIR, "dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rows = {}
    rows["train-dp-nccl1"], alone, again = train_dp_nccl1_phase(
        torch, conf2d, device, DP_COMPARED, DP_NCCL1_TIMED)
    yield "train-dp-nccl1", rows["train-dp-nccl1"]
    rows["fused-adam"] = fused_adam_phase(torch, conf2d, device, alone, again)
    yield "fused-adam", rows["fused-adam"]
    ref3d = dp_3d_reference(torch, conf3d, device)
    torch.save({k: ref3d[k] for k in ("vb", "mb", "th", "norms")}, os.path.join(work, "ref3d.pt"))
    exp_alone = dp_experiment(torch, dp_experiment_conf(os.path.join(work, "experiment_alone")),
                              device, None)
    exp_again = dp_experiment(torch, dp_experiment_conf(os.path.join(work, "experiment_again")),
                              device, None)
    sync()
    if device == "cuda":
        torch.cuda.empty_cache()
    shapes3d = [(1, 2), (2, 1)]
    t0 = time.perf_counter()
    ctx = mp.start_processes(dp_rank, args=(_free_port(), work, device, conf2d, conf3d, shapes3d,
                                            tp[0]),
                             nprocs=2, join=False, start_method="spawn")
    while not ctx.join(timeout=600):
        pass
    ranks_s = time.perf_counter() - t0
    res = [torch.load(os.path.join(work, "rank%d.pt" % r), weights_only=False) for r in range(2)]
    want2d = {k: v * DP_TIMED for k, v in launches_per_batch(conf2d).items()}
    want3d = {k: 2 * DP_TIMED if k == "nearest_warp" else 0 for k in KERNEL_NAMES}

    # train-dp: each rank against the one process on the whole batches
    per_rank = []
    for rank, r in enumerate(res):
        t = r["train-dp"]
        gaps = dp_check_against("train-dp rank %d" % rank, t, alone, again, rank)
        gaps.pop("one_process_rerun")
        if device == "cuda":
            check(t["launches"] == want2d, "train-dp rank %d launches %s" % (rank, t["launches"]))
        per_rank.append({"rank": rank, **gaps,
                         "min_anatomy_distance_from_half_step1":
                             t["min_anatomy_distance_from_half_step1"],
                         "launches": t["launches"],
                         "p50_ms_per_step": t["p50_ms_per_step"], "ms_per_step": t["ms_per_step"]})
    rows["train-dp"] = {
        "backend": res[0]["backend"], "ranks": 2, "cards": 1, "batch": conf2d.batch_size,
        "batch_per_rank": conf2d.batch_size // 2, "compared_steps": DP_COMPARED,
        "timed_steps": DP_TIMED, "ranks_wall_s": ranks_s,
        "p50_ms_per_step_one_process": rows["train-dp-nccl1"]["p50_ms_per_step_mesh_free"],
        "note": "two gloo ranks on one card: every collective goes through the host; "
                "not a scaling figure",
        "one_process_rerun": rows["train-dp-nccl1"]["one_process_rerun"],
        "per_rank": per_rank}
    yield "train-dp", rows["train-dp"]

    rows["train-tp"] = train_tp_rows(res, alone, again, conf2d, device, *tp)
    yield "train-tp", rows["train-tp"]

    # train-3d-dp: each mesh on each rank against the unsharded step
    exempt = {"ConvBlock3D_%d.Conv_%d.bias" % (b, c)
              for b in range(2 * conf3d.downsample3d + 1) for c in (0, 1)}
    top = max(g.abs().max().item() for g in ref3d["grads"].values())
    meshes = []
    for i, shape in enumerate(shapes3d):
        for rank, r in enumerate(res):
            t = r["train-3d-dp"][i]
            loss_rel = abs(t["loss"] / ref3d["loss"] - 1.0)
            check(loss_rel <= 2e-5, "train-3d-dp %s loss differs by %.3g" % (shape, loss_rel))
            rel = {n: ((t["grads"][n] - g).abs().max() / g.abs().max()).item()
                   for n, g in ref3d["grads"].items() if n not in exempt}
            bad = {n: v for n, v in rel.items() if not v <= DP_3D_GRAD_REL}
            check(not bad, "train-3d-dp %s gradients differ: %s" % (shape, bad))
            zero = max((t["grads"][n] - ref3d["grads"][n]).abs().max().item() for n in exempt)
            if device == "cuda":
                check(t["launches"] == want3d, "train-3d-dp launches %s" % t["launches"])
            meshes.append({"mesh": t["mesh"], "rank": rank, "loss": t["loss"],
                           "loss_rel_diff": loss_rel, "max_grad_rel_diff": max(rel.values()),
                           "zero_gradient_biases_max_diff_over_top": zero / top,
                           "relu_kinks_aligned": t["kinks"], "halo": t["halo"],
                           "launches": t["launches"], "p50_ms_per_step": t["p50_ms_per_step"],
                           "ms_per_step": t["ms_per_step"]})
    rows["train-3d-dp"] = {"backend": res[0]["backend"], "ranks": 2, "cards": 1,
                           "batch": conf3d.batch_size, "volume": list(conf3d.volume_shape),
                           "filters3d": conf3d.filters3d, "downsample3d": conf3d.downsample3d,
                           "loss_unsharded": ref3d["loss"], "timed_steps": DP_TIMED,
                           "note": "two gloo ranks on one card: not a scaling figure",
                           "meshes": meshes}
    yield "train-3d-dp", rows["train-3d-dp"]

    # experiment-dp: the 2-rank executor against the one process, beside
    # the one process's own run-to-run spread (B2's atomics on the card)
    def csv_gaps(got, ref):
        """{column: largest relative difference over the rows}"""
        check(len(got) == len(ref), "training.csv rows %d != %d" % (len(got), len(ref)))
        return {k: max(abs(float(g[k]) - float(w[k])) / max(abs(float(w[k])), 1e-30)
                       for g, w in zip(got, ref)) for k in ref[0]}
    e0, e1 = res[0]["experiment-dp"], res[1]["experiment-dp"]
    biases = set(exp_alone["biases_ahead_of_batchnorm"])
    csv_spread = csv_gaps(exp_again["training_csv"], exp_alone["training_csv"])
    swa_spread = dp_state_gap(exp_again["swa"], exp_alone["swa"], biases, exp_alone["budget"])
    for e in (e0, e1):
        check((e["epoch"], e["step"], e["stopped_epoch"]) ==
              (exp_alone["epoch"], exp_alone["step"], exp_alone["stopped_epoch"]),
              "experiment-dp stops at %s, alone at %s" % (
                  (e["epoch"], e["step"], e["stopped_epoch"]),
                  (exp_alone["epoch"], exp_alone["step"], exp_alone["stopped_epoch"])))
        swa_gap = dp_state_gap(e["swa"], exp_alone["swa"], biases, exp_alone["budget"])
        lim = max(5e-3, 3 * swa_spread["share_past_1e-5_rel"])
        check(swa_gap["share_past_1e-5_rel"] <= lim and
              max(swa_gap["max_over_budget_biases_ahead_of_batchnorm"],
                  swa_gap["max_over_budget_other"]) <= 2.001,
              "experiment-dp SWA weights: %s (the one process's rerun: %s)"
              % (swa_gap, swa_spread))
        if device == "cuda":
            check(e["launches"] == e["launches_want"],
                  "experiment-dp launches %s != %s" % (e["launches"], e["launches_want"]))
    check(e0["writes"] == exp_alone["writes"] and e1["writes"] == {},
          "experiment-dp writes: rank 0 %s, rank 1 %s, alone %s"
          % (e0["writes"], e1["writes"], exp_alone["writes"]))
    csv_gap = csv_gaps(e0["training_csv"], exp_alone["training_csv"])
    for k, v in csv_gap.items():
        check(v <= max(1e-3, 10 * csv_spread[k]), "experiment-dp training.csv %s differs by %.3g "
              "(the one process's own spread %.3g)" % (k, v, csv_spread[k]))
    rows["experiment-dp"] = {"backend": res[0]["backend"], "ranks": 2, "config": "tiny",
                             "epochs_run": e0["epoch"] + 1, "stopped_epoch": e0["stopped_epoch"],
                             "steps": e0["step"],
                             "training_csv_max_rel_diff": max(csv_gap.values()),
                             "one_process_rerun_training_csv_max_rel_diff":
                                 max(csv_spread.values()),
                             "swa": swa_gap, "one_process_rerun_swa": swa_spread,
                             "writes_rank0": e0["writes"], "writes_rank1": e1["writes"],
                             "writes_one_process": exp_alone["writes"],
                             "launches": [e0["launches"], e1["launches"]]}
    yield "experiment-dp", rows["experiment-dp"]


def train_profile_phase(torch, conf, device, warmup=2, steps=3):
    """profile_steps over `steps` step_supervised calls (after `warmup`)."""
    _, ts, step, batches = _train_setup(torch, conf, device)
    for _ in range(warmup):
        ts, _ = step(ts, next(batches))
    feed = iter([next(batches) for _ in range(steps)])

    def run():
        nonlocal ts
        ts, _ = step(ts, next(feed))
    return profile_steps(torch, run, steps)


def profile_steps(torch, run, steps):
    """torch.profiler over `steps` calls of run(): device time by kernel
    and by kind (the benchmark's kernel_kind), and the share of the window
    the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.trace import kernel_kind

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    device_us = sum(r[0] for r in rows)
    check(device_us > 0, "the profiler saw no device time")
    kinds = {}
    for us, key, _ in rows:
        kinds[kernel_kind(key)] = kinds.get(kernel_kind(key), 0.0) + us
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


def env_phase(torch, smi):
    """The card's name and count, nvidia-smi's name and power limit, the
    versions, both TF32 flags and the process-group backends."""
    return {"device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "nccl_available": torch.distributed.is_nccl_available(),
            "gloo_available": torch.distributed.is_gloo_available()}


def build_phase():
    """Every CUDA kernel built from csrc/: seconds, ptxas lines."""
    from multimodal_segmentation_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    builds = cuda_kernels.build_all()
    return {"seconds": time.perf_counter() - t0, "kernels": builds}


def kernels_phase(torch, dev):
    """The kernels line: each kernel's rows, and B5's device time over B1's
    at the shapes they share."""
    kern = {
        "tps_warp_fwd": warp_fwd_phase(torch, dev),
        "warp_general": warp_general_phase(torch, dev),
        "tps_warp_bwd": warp_bwd_phase(torch, dev),
        "tps_warp_bwd_auto": warp_bwd_auto_phase(torch, dev),
        "rotation": rotation_phase(torch, dev),
        "rotation_auto": rotation_auto_phase(torch, dev),
        "round_ste": round_ste_phase(torch, dev),
        "bn_epilogue": bn_epilogue_phase(torch, dev),
        "thin_conv3d": thin_conv3d_phase(torch, dev),
        "same_conv3d": same_conv3d_phase(torch, dev),
        "launch_path": launch_path_phase(torch, dev),
        "flow": flow_phase(torch, dev),
        "nearest_warp_3d": nearest_warp_3d_phase(torch, dev),
    }
    fwd, flow = kern["tps_warp_fwd"], kern["flow"]
    flow["share_of_b1_device_ms"] = {
        "train B=12 f32": flow["B=12"]["device_ms"] / fwd["train_float32"]["device_ms"],
        "infer B=24 bf16": flow["B=24"]["device_ms"] / fwd["bfloat16"]["device_ms"],
        "infer B=24 f32": flow["B=24"]["device_ms"] / fwd["float32"]["device_ms"],
        "train B=12 bf16": flow["B=12"]["device_ms"] / fwd["train_bfloat16"]["device_ms"],
    }
    return kern


def slice_rows(torch, conf, device):
    """slice, cross-device (on the slice's model and first volume) and
    slice-bf16 (against the slice's argmaxes and p50s): (phase, row)."""
    model, warm, res, argmaxes = slice_phase(torch, conf, device)
    yield "slice", res
    yield "cross-device", cross_device_phase(torch, conf, model, warm, device)
    del model, warm
    bf16 = dataclasses.replace(conf, eval_dtype="bfloat16", folder=conf.folder + "_bf16")
    yield "slice-bf16", slice_phase(torch, bf16, device, (argmaxes, res["p50_ms_per_volume"]))[2]


def in_both_dtypes(phases, run, conf):
    """run(conf) at compute_dtype float32, then at bfloat16 with its p50
    over the float32 row's: (phase, row), the phases named `phases`."""
    f32 = run(dataclasses.replace(conf, compute_dtype="float32"))
    yield phases[0], f32
    bf16 = run(dataclasses.replace(conf, compute_dtype="bfloat16"))
    bf16["p50_over_f32"] = bf16["p50_ms_per_step"] / f32["p50_ms_per_step"]
    yield phases[1], bf16


def phase_table(torch, config, card, smi):
    """Every phase, once, in the order of the card run's lines: (name,
    run). run() returns the phase's row, or yields (phase, row) for each of
    its lines. Where a phase runs otherwise on the card than in
    --cpu-rehearsal, pick(on the card, in the rehearsal) gives both: full
    width on the card, the tiny config on the CPU; a run that picks None
    has no rehearsal (env, build and the kernels)."""
    dev = "cuda" if card else "cpu"

    def pick(on_card, rehearsal):
        return on_card if card else rehearsal

    def synthetic(conf, **fields):
        return dataclasses.replace(conf, dataset_name="synthetic", **fields)

    def dafnet(**fields):
        return synthetic(pick(config.dafnet_chaos(), config.tiny_test_config()), **fields)

    def mmsdnet(**fields):
        return synthetic(pick(config.mmsdnet_chaos(), config.tiny_test_config("mmsdnet")),
                         **fields)

    def train(steps):
        return lambda conf: train_phase(torch, conf, dev, *pick((TRAIN_WARMUP, steps), (1, 2)))

    small_3d = {k: getattr(tiny_3d(), k) for k in ("volume_shape", "filters3d", "downsample3d")}
    return (
        ("env", pick(lambda: env_phase(torch, smi), None)),
        ("build", pick(build_phase, None)),
        ("kernels", pick(lambda: kernels_phase(torch, torch.device("cuda", 0)), None)),
        ("dp-kernels", pick(lambda: dp_kernels_phase(torch, torch.device("cuda", 0)), None)),
        ("debug-warp", lambda: debug_warp_phase(torch, dev)),
        ("slice, cross-device, slice-bf16", lambda: slice_rows(torch, dafnet(
            test_dataset="synthetic",
            folder=os.path.join(OUT_DIR, pick("dafnet_chaos", "rehearsal"))), dev)),
        ("train, train-bf16", lambda: in_both_dtypes(
            ("train", "train-bf16"), train(TRAIN_STEPS), dafnet())),
        ("lockstep", lambda: lockstep_phase(torch, dev)),
        ("train-spade", lambda: in_both_dtypes(("train-spade",) * 2, train(SPADE_STEPS), synthetic(
            pick(config.dafnet_spade_chaos(), config.tiny_test_config("dafnet", "spade"))))),
        ("train-cross-device", lambda: train_cross_device_phase(torch, dev)),
        ("train-auto", lambda: in_both_dtypes(
            ("train-auto",) * 2, train(NEW_TRAIN_STEPS), dafnet(automatedpairing=True))),
        ("train-mmsdnet", lambda: in_both_dtypes(
            ("train-mmsdnet",) * 2, train(NEW_TRAIN_STEPS), mmsdnet())),
        ("train-mmsdnet-remat", lambda: remat_phase(
            torch, dev, {dt: mmsdnet(compute_dtype=dt) for dt in ("float32", "bfloat16")},
            pick(REMAT_TIMED, 1))),
        ("experiment", lambda: experiment_phase(torch, dev, pick("dafnet_config_chaos", "tiny"))),
        ("experiment-paths", lambda: experiment_paths_phase(torch, dev, pick(
            (("dafnet_config_chaos", "--automatedpairing"), ("mmsdnet_config_chaos",)),
            (("tiny", "--automatedpairing"), ("tiny_mmsdnet",))))),
        ("balancer-order", lambda: balancer_order_phase(torch, dev)),
        ("chaos", lambda: chaos_phase(torch, dev, tiny=not card)),
        ("train-3d", lambda: in_both_dtypes(("train-3d",) * 2, lambda conf: train3d_phase(
            torch, conf, dev, *pick((TRAIN_WARMUP, TRAIN3D_STEPS, TRAIN3D_PROFILE_STEPS), (1, 2))),
            pick(config.cardiac_3d(), tiny_3d()))),
        ("train-3d-cross-device", lambda: train3d_cross_device_phase(torch, dev)),
        ("experiment-3d", lambda: experiment3d_phase(torch, dev, "cardiac_3d_config",
                                                     **pick({}, small_3d))),
        ("train-dp-nccl1, fused-adam, train-dp, train-tp, train-3d-dp, experiment-dp",
         lambda: dp_phases(torch, dev, dafnet(), pick(config.cardiac_3d(), tiny_3d()),
                           pick((TP_MIN_FEATURES, TP_LEAVES), (16, 17)))),
    )


def summary(rows, main_dtype):
    """The kernels summary: each kernel at its main shape (B1 in
    `main_dtype`) and its other shapes, with its launches on every path the
    run took (the slice, train, lockstep, experiment, dress rehearsal,
    warp-bisect, 3-D, remat and data-parallel phases, and the kernels
    line's own)."""
    kern = rows["kernels"]
    paths = {k: rows[k]["launches"] for k in (
        "slice", "slice-bf16", "train", "train-bf16", "lockstep", "train-spade",
        "train-spade-bf16", "experiment", "chaos", "debug-warp", "train-auto", "train-auto-bf16",
        "train-mmsdnet", "train-mmsdnet-bf16")}
    paths.update({"experiment-" + k: {n: v["launches"][n] + v["test_launches"][n]
                                      for n in v["launches"]}
                  for k, v in rows["experiment-paths"].items()})
    exp3d = rows["experiment-3d"]
    paths.update({
        "balancer-order": rows["balancer-order"]["launches"],
        "train-3d": rows["train-3d"]["launches"], "train-3d-bf16": rows["train-3d-bf16"]["launches"],
        "experiment-3d": {n: exp3d["launches"][n] + exp3d["test_launches"][n]
                          for n in exp3d["launches"]},
        "warp-general": kern["warp_general"]["launches"],
        "unet3d-forward": kern["thin_conv3d"]["forward"]["launches"],
        "swin-forward": kern["same_conv3d"]["forward"]["launches"],
        **{"train-mmsdnet-remat-" + k: v["launches"]
           for k, v in rows["train-mmsdnet-remat"].items()},
        "fused-adam": rows["fused-adam"]["launches"],
        "train-tp": _summed(r["launches"] for r in rows["train-tp"]["per_rank"]),
        "train-dp-nccl1": rows["train-dp-nccl1"]["launches"],
        "train-dp": _summed(r["launches"] for r in rows["train-dp"]["per_rank"]),
        "train-3d-dp": _summed(m["launches"] for m in rows["train-3d-dp"]["meshes"]),
        "experiment-dp": _summed(rows["experiment-dp"]["launches"])})
    launches = {k: sum(p[k] for p in paths.values()) for k in rows["train"]["launches"]}
    src = "multimodal_segmentation_torch/csrc/"
    pallas = "multimodal_segmentation_tpu/ops/pallas_kernels.py:"
    # each row's fields that the summary keeps; bound_by where the row has
    # one (work_bound's rows: the benchmark's call_bound_s gives seconds)
    fields = ("max_abs_err", "ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "library_device_ms", "library_host_ms")
    shape_fields = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")
    # the shapes the later slices' paths give the kernels: automated
    # pairing (slice 9), the volumetric rotation (slice 10)
    more_shapes = {
        "tps_warp_fwd": {"B=36 float32": kern["tps_warp_fwd"]["train_auto_float32"],
                         "B=36 bfloat16": kern["tps_warp_fwd"]["train_auto_bfloat16"]},
        "tps_warp_bwd": {"B=36 float32": kern["tps_warp_bwd_auto"]},
        "nearest_warp": {"3+3+4+4 channels": kern["rotation_auto"],
                         "(32, 128, 128, 3) float32 volumes": kern["nearest_warp_3d"]["volumes"],
                         "(32, 128, 128, 3) float32 masks": kern["nearest_warp_3d"]["masks"]},
        "round_ste": {"(36, 8, 192, 192) float32": kern["round_ste"]["train_auto_float32"]},
        "tps_flow_dbg": {},
        "bn_epilogue": {key: row for key, row in kern["bn_epilogue"].items()
                        if key != "76x64x192x192_bfloat16"},
        "thin_conv3d": {"(2, 3, 116, 132, 132) bfloat16": kern["thin_conv3d"]["B=2"]},
        "same_conv3d": {"%s bfloat16" % (s,): kern["same_conv3d"][str(s)]
                        for s in SAME_SHAPES[:1] + SAME_SHAPES[2:]},
    }
    out = []
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
             "stage at its inference shape"),
            ("bn_epilogue", "bn_epilogue.cu", "none: XLA fuses the chain in the JAX package",
             kern["bn_epilogue"]["76x64x192x192_bfloat16"], "(76, 64, 192, 192) bfloat16, "
             "ReLU on: the up path's last level of a 38-slice study in serving"),
            ("thin_conv3d", "thin_conv3d.cu", "none: cuDNN has only a legacy kernel for 3 "
             "input channels", kern["thin_conv3d"]["B=16"], "(16, 3, 116, 132, 132) -> 32 "
             "bfloat16: the 3D U-Net's first convolution on a serving forward's tiles"),
            ("same_conv3d", "same_conv3d.cu", "none: cuDNN runs these shapes in an sm80 "
             "kernel at 12-19 % of the bf16 peak", kern["same_conv3d"][str(SAME_SHAPES[1])],
             "(1, 96, 128, 128, 128) -> 48 bfloat16: Swin UNETR decoder1's first "
             "convolution of a window")):
        out.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {p: counts[name] for p, counts in paths.items()},
            **{f: k[f] for f in fields if f in k},
            "work": work,
            "more_shapes": {case: {f: r[f] for f in shape_fields if f in r}
                            for case, r in more_shapes[name].items()},
        })
    g = kern["warp_general"]
    out.insert(1, {
        "name": "tps_warp_fwd (general entry)",
        "route": "cuda",
        "source": src + "tps_warp.cu",
        "replaces": pallas + "315",
        "launches": sum(p.get("tps_warp_fwd_general", 0) for p in paths.values()),
        "launches_by_path": {p: c["tps_warp_fwd_general"] for p, c in paths.items()
                             if "tps_warp_fwd_general" in c},
        **{f: g[f] for f in fields},
        "work": "B=12 192x192 C=8 float32, inverse mapping (per-image centres), order 2, "
                "25 points; also orders 1, 3, 4 and a 4x4 grid, and bf16 (max_abs_err over "
                "all): tps_warp's general entry, launched by the warp-general path",
        "more_shapes": {"%s %s" % (case, dtype): {f: row[dtype][f] for f in shape_fields}
                        for case, row in g["cases"].items() for dtype in ("float32", "bfloat16")
                        if dtype in row and (case, dtype) != ("inverse", "float32")},
    })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="every phase but env, build, kernels and dp-kernels at the "
                         "tiny config on the CPU; no result line")
    ap.add_argument("--profile-train", action="store_true",
                    help="only profile full-width train steps on the card; "
                         "no result line")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "multimodal_segmentation_torch")):
        sys.exit("chip_smoke.py: the multimodal_segmentation_torch package is "
                 "not in %s; run it from the repository" % REPO)
    sys.path.insert(0, REPO)
    # the chaos phase's tree; the CHAOS loader reads this when its module
    # first loads (every other phase names the synthetic loader)
    os.environ["MMSEG_TPU_CHAOS_DIR"] = CHAOS_ROOT
    import torch

    from multimodal_segmentation_torch import config

    card = not args.cpu_rehearsal
    smi = None
    if card:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
                     "false); this script needs one GPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi()
        if args.profile_train:
            conf = dataclasses.replace(config.dafnet_chaos(), dataset_name="synthetic")
            emit("train-profile", card=smi, **train_profile_phase(torch, conf, "cuda"))
            return 0
    else:
        # the experiment phases' CLI runs name the tiny configs as presets
        config.PRESETS.setdefault("tiny", config.tiny_test_config)
        config.PRESETS.setdefault("tiny_mmsdnet", lambda: config.tiny_test_config("mmsdnet"))

    rows = {}
    for name, run in phase_table(torch, config, card, smi):
        if run is None:
            continue
        out = run()
        for phase, row in [(name, out)] if isinstance(out, dict) else out:
            # a phase's second line (its bf16 row) is kept as <phase>-bf16
            rows[phase + "-bf16" if phase in rows else phase] = row
            emit(phase, **({"card": smi} if card and phase != "env" else {}), **row)
            if card:
                torch.cuda.empty_cache()
    if not card:
        return 0
    kernels = summary(rows, "bfloat16" if config.dafnet_chaos().eval_warp == "bf16" else "float32")
    emit("total", seconds=time.perf_counter() - _T0)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
