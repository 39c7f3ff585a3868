"""The infer3d harness: one client in a closed loop sends whole 3-channel
volumes to the program's volumetric segmenter (Cardiac3DSegmenter.predict,
overlap-tile through the configuration's net) for `seconds`, then the
output check.

A request is one volume, a (1, D, H, W, C) float32 array on the host; it
is timed until its class probabilities, (1, D, H, W, classes) float32, are
back on the host, in the client's own reused host array. The volumes cycle through a pool (traffic/volumes.py),
each pass in a fresh seeded order; set-up warms every volume of the pool
once, which runs every tile batch and volume shape that the window runs.
After the window a seeded sample of the served volumes, the deepest
volume among them, is run once through the reference's own overlap-tile
(reference/<model>.py::predict_volume) and compared:

  volume_gap     the largest relative gap of a class's volume (its summed
                 probability) in a volume
  region_gap     the largest, over the volumes and classes, of the summed
                 absolute gap of the class's probability mass in each block
                 of a REGIONS^3 grid of the volume, over the class's volume:
                 it sees a tile stitched in the wrong place or a mirrored
                 axis, which keep every class's volume
  mask_mismatch  the share of voxels whose most likely class differs (no
                 limit: printed by control.py)
"""

import gc
import math
import sys
import time
import types

import numpy as np
import torch

from benchmark.harness import check, common, program
from benchmark.harness.trace import Spans, Trace, profiler
from benchmark.reference.precision import set_precision
from benchmark.traffic import studies, volumes
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter

REGIONS = 8
# control.py's modes: the program as a run drives it (a short window); the
# reference in fp8 (the control) or in float32 in the program's place over
# the volumes a run checks, no window; a run with a fault planted under
# the timed path (FAULTS)
MODES = ("sound", "control", "float32", "shifted", "mirrored")
# the CPU cut (tests/tiny.py): a few volumes of 2 x 2 x 2 tiles of the 4^3
# output tile, the sizes chosen so that no axis's mirror period (2 (n - 1))
# is a multiple of the 8 voxels of three poolings; limits a little above
# what sound runs read there in float32
TINY_TRAFFIC = {"depths": [6, 7], "repeat": 1, "hw": [6, 7], "sample_from": 1, "sampled": 1}
TINY_CHECKS = {"volume_gap": 1e-4, "region_gap": 1e-4}


def shifted(predict, tile):
    """A stitch shifted by one output tile along W."""
    return lambda *args: predict(*args).roll(tile[2], dims=3)


def mirrored(predict, tile):
    """The answers mirrored along H."""
    return lambda *args: predict(*args).flip(2)


FAULTS = {"shifted": shifted, "mirrored": mirrored}


class Inputs:
    def __init__(self, workload, config, seed, device, bench_dir=common.BENCH_DIR):
        self.workload = workload
        self.seeds = common.seeds(seed)
        fields = common.model_fields(config, workload, self.seeds.conf)
        self.conf = program.experiment_config(fields)
        self.ref_conf = common.namespace(fields)
        self.reference = common.reference_model(config, bench_dir)
        self.device = device
        t = workload["traffic"]
        self.pool = volumes.request_pool(t, self.seeds.studies, device)
        # the output tile of the reference's input tile, and the tiles that
        # serving each volume of the pool takes: the run's unit of work
        with torch.device("meta"):
            self.tile_out = sys.modules[self.reference.__module__].output_tile(
                self.reference(self.ref_conf))
        self.tiles = [math.prod(-(-s // o) for s, o in zip(v.shape[1:4], self.tile_out))
                      for v in self.pool]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.state = volumes.make_weights(self.reference, self.ref_conf, t, self.seeds.weights,
                                          device)

    def sample(self):
        """Which requests are kept for the check: `sampled` positions drawn
        from the first `sample_from`, and the first of the deepest volume."""
        t = self.workload["traffic"]
        rng = np.random.RandomState(self.seeds.sample)
        return set(rng.choice(t["sample_from"], size=t["sampled"], replace=False).tolist())

    def deepest(self):
        depths = [v.shape[1] for v in self.pool]
        return depths.index(max(depths))


def reference_probabilities(inputs, kept, precision):
    """The reference's probabilities of the kept volumes, (1, D, H, W,
    classes) host arrays, at `precision`, in tile batches of the
    configuration's batch size."""
    reference = inputs.reference
    model = reference(inputs.ref_conf)
    model.load_state_dict(inputs.state)
    model = set_precision(model.to(inputs.device), precision).eval()
    predict = sys.modules[reference.__module__].predict_volume
    return [predict(model, inputs.pool[i][0], inputs.ref_conf.batch_size, inputs.device)[None]
            for i in kept]


def _blocks(x, regions):
    """(regions, regions, regions, classes) mass of each block of (D, H, W,
    classes) x, the blocks as even as the sizes allow."""
    for axis in range(3):
        n = x.shape[axis]
        block = torch.div(torch.arange(n) * regions, n, rounding_mode="floor")
        shape = list(x.shape)
        shape[axis] = regions
        x = torch.zeros(shape, dtype=x.dtype).index_add_(axis, block, x)
    return x


def volume_numbers(got, ref):
    """got, ref: lists of (1, D, H, W, classes) probabilities of the same
    volumes; no volume at all reads as inf."""
    if not got:
        return dict.fromkeys(("mask_mismatch", "volume_gap", "region_gap"), math.inf)
    diff = total = 0
    volume = region = 0.0
    for g, r in zip(got, ref):
        g, r = torch.as_tensor(g)[0].double(), torch.as_tensor(r)[0].double()
        diff += int((g.argmax(-1) != r.argmax(-1)).sum())
        total += g[..., 0].numel()
        vr = r.sum((0, 1, 2)).clamp(min=1.0)
        volume = max(volume, float(((g.sum((0, 1, 2)) - r.sum((0, 1, 2))).abs() / vr).max()))
        mg, mr = _blocks(g, REGIONS), _blocks(r, REGIONS)
        region = max(region, float(((mg - mr).abs().sum((0, 1, 2)) / vr).max()))
    nums = {"mask_mismatch": diff / total, "volume_gap": volume, "region_gap": region}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in nums.items()}


def unit_of_work(conf, workload, model_cls):
    """One input tile through the reference on meta tensors, as a function
    that flops/count.py counts."""
    with torch.device("meta"):
        model = model_cls(conf).eval()
    x = torch.zeros((1, conf.volume_shape[3]) + tuple(conf.volume_shape[:3]), device="meta")
    return lambda: model(x)


def reading(mode, seed, seconds, workload, config, device, bench_dir=common.BENCH_DIR):
    """control.py's numbers of one seed. sound and the faults: a window of
    `seconds` (the faults planted under the timed path); control and
    float32: the reference at that precision against the reference at the
    configuration's, over the volumes a run checks (the sample taken as
    pool positions and the deepest volume), no window."""
    if mode in ("control", "float32"):
        inputs = Inputs(workload, config, seed, device, bench_dir)
        kept = sorted(inputs.sample() | {inputs.deepest()})
        got = reference_probabilities(inputs, kept, "fp8" if mode == "control" else "float32")
        ref = reference_probabilities(inputs, kept, inputs.ref_conf.compute_dtype)
        return volume_numbers(got, ref), {"volumes": [list(inputs.pool[i].shape) for i in kept]}
    wrap = FAULTS.get(mode)
    res = run(seed, seconds, False, workload, config, time.perf_counter(), device, wrap, bench_dir)
    return res.numbers, {"requests": res.attempted}


def build(inputs, device):
    """The program's segmenter and its net holding the benchmark's weights."""
    segmenter = Cardiac3DSegmenter(inputs.conf, device=device)
    net, _ = segmenter.init(state_dict=inputs.state)
    return segmenter, net


def run(seed, seconds, trace, workload, config, t0, device, wrap_predict=None,
        bench_dir=common.BENCH_DIR):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    parts = {"start": time.perf_counter() - t0}
    inputs = Inputs(workload, config, seed, device, bench_dir)
    parts["inputs"] = time.perf_counter() - t0
    segmenter, net = build(inputs, device)
    parts["program"] = time.perf_counter() - t0
    predict = segmenter.predict
    if wrap_predict is not None:
        predict = wrap_predict(predict, inputs.tile_out)

    # the client's own host array, as large as the largest answer, into
    # which each answer is copied: a pageable copy into memory already
    # touched. `.cpu()` into fresh memory spent 21-40 ms a volume, most of
    # it faulting pages in, and its swings set the latency's tail
    classes = inputs.conf.num_masks + 1
    host = np.zeros(max(v[0, ..., 0].size for v in inputs.pool) * classes, np.float32)

    def request(i):
        probs = predict(net, inputs.pool[i])
        out = host[:probs.numel()].reshape(probs.shape)
        torch.from_numpy(out).copy_(probs)
        return out

    for i in range(len(inputs.pool)):
        request(i)
    sync()
    setup_s = time.perf_counter() - t0
    parts["warmup"] = setup_s

    order = studies.request_order(len(inputs.pool), inputs.seeds.studies)
    keep = inputs.sample()
    deepest = inputs.deepest()
    kept, latencies, tiles, failed = [], [], 0, 0
    program.reset_launch_counts()
    spans = Spans(trace)
    prof = profiler() if trace else None
    if prof:
        prof.start()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        i = next(order)
        with spans("request"):
            t_req = time.perf_counter()
            probs = request(i)
            latencies.append(time.perf_counter() - t_req)
        tiles += inputs.tiles[i]
        if probs.shape != inputs.pool[i].shape[:4] + (classes,) or not np.isfinite(probs).all():
            failed += 1
        k = len(latencies) - 1
        if k in keep or (i == deepest and all(j != deepest for j, _ in kept)):
            kept.append((i, probs.copy()))
    sync()
    window_s = time.perf_counter() - start
    if prof:
        prof.stop()
    launches = program.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = Trace(prof, window_s, spans) if prof else None
    del segmenter, net, predict, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_probabilities(inputs, [i for i, _ in kept], inputs.ref_conf.compute_dtype)
    nums = volume_numbers([p for _, p in kept], ref)
    correct, checks = check.verdict(nums, workload["checks"])
    return types.SimpleNamespace(
        correct=correct and failed == 0, checks=checks, numbers=nums, left_out=None,
        attempted=len(latencies), failed=failed, setup_s=setup_s, window_s=window_s,
        # the tiles served count as the run's units (`slices` to the
        # readers), as the configuration's flops count one tile
        steps=len(latencies), slices=tiles, latencies_s=latencies,
        memory_peak_bytes=peak, launches=launches, trace=traced, shapes=None, shape_units=0,
        setup_parts=parts)
