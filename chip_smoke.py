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
                library times
  slice         ModelTester on the synthetic loader's split-0 test volumes,
                modality t2, fusions simple/def/max on expert and randomised
                pairs, at full dafnet_chaos width with seeded weights: Dice
                per fusion, per-volume p50 latency, kernel launches, peak
                device memory
  cross-device  predict_mask(1, 'max') on two slices on the card and on the
                CPU with the same weights: share of pixels whose argmax
                differs, max probability difference elsewhere

Then nvidia-smi's name/power line, the kernels summary and, last, the result
line. Any failed check raises, and the script exits non-zero without a
result line; so it does without a CUDA device, or outside the repository.

  python3 chip_smoke.py                  # needs one CUDA device
  python3 chip_smoke.py --cpu-rehearsal  # slice + cross-device at the tiny
                                         # config on the CPU with the plain
                                         # versions; prints no result line
"""

import argparse
import csv
import json
import os
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


def kernel_phase(torch, dev):
    """tps_warp_fwd at the inference shapes: B = 24 (a padded volume),
    192x192, C = 8 anatomy channels."""
    import numpy as np
    import torch.nn.functional as F

    from multimodal_segmentation_torch.ops import tps
    from multimodal_segmentation_torch.ops.cuda_kernels import tps_warp_fwd

    B, H, W, C = 24, 192, 192, 8
    r = np.random.RandomState(0)
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
    cp = tps.control_grid((5, 5), dev)
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

        off = cases["small"]
        wv = tps.tps_coefficients(off)
        locs = tps.tps_sample_locations(off, (H, W))
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=dev)
        grid = (locs.flip(-1) * scale - 1.0).reshape(B, H, W, 2).to(dtype)
        nbytes = vol.numel() * vol.element_size()
        bufs = rotating(lambda: vol.clone(), nbytes)
        it = {"k": 0, "p": 0, "l": 0}

        def kernel():
            it["k"] += 1
            tps_warp_fwd(bufs[it["k"] % len(bufs)], wv, cp)

        def plain():
            it["p"] += 1
            tps._tps_warp_plain(bufs[it["p"] % len(bufs)], off)

        def library():
            it["l"] += 1
            F.grid_sample(bufs[it["l"] % len(bufs)].permute(0, 3, 1, 2), grid,
                          mode="bilinear", padding_mode="zeros", align_corners=True)

        lib_out = F.grid_sample(vol.permute(0, 3, 1, 2), grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
        lib_diff = (lib_out.permute(0, 2, 3, 1).float()
                    - tps_warp_fwd(vol, wv, cp).float()).abs().max().item()
        # bound: each input read once, the output written once; operations
        # per point: 25 RBF terms of ~13 (a logf counted as one) + ~20 for
        # the affine term and corner weights + 8 per channel for the blend
        moved = 2 * nbytes + wv.numel() * 4 + cp.numel() * 4
        flops = B * H * W * (25 * 13 + 20 + 8 * C)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
        ms, ms_spread = time_ms(kernel)
        plain_ms, plain_spread = time_ms(plain, iters=10)
        library_ms, library_spread = time_ms(library)
        res[name] = {
            "max_abs_err": max(errs.values()),
            "errors": errs,
            "cases": cover,
            "ms": ms,
            "ms_spread": ms_spread,
            "plain_ms": plain_ms,
            "plain_ms_spread": plain_spread,
            "library_ms": library_ms,
            "library_ms_spread": library_spread,
            "library_max_abs_diff": lib_diff,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved,
            "flops": flops,
        }
        del bufs
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="slice + cross-device at the tiny config on the CPU; "
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
        return 0

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
                 "false); this script needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from multimodal_segmentation_torch.ops import cuda_kernels

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
    kern = kernel_phase(torch, dev)
    emit("kernels", tps_warp_fwd=kern, card=smi)

    conf = config.dafnet_chaos()
    conf.test_dataset, conf.folder = "synthetic", os.path.join(OUT_DIR, "dafnet_chaos")
    model, warm, res = slice_phase(torch, conf, "cuda")
    emit("slice", card=smi, **res)
    emit("cross-device", **cross_device_phase(torch, conf, model, warm, "cuda"))

    main_dtype = "bfloat16" if conf.eval_warp == "bf16" else "float32"
    k = kern[main_dtype]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "tps_warp_fwd",
        "route": "cuda",
        "source": "multimodal_segmentation_torch/csrc/tps_warp.cu",
        "replaces": "multimodal_segmentation_tpu/ops/pallas_kernels.py:315",
        "launches": res["launches"]["tps_warp_fwd"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "dtype": main_dtype,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
