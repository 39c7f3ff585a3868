"""The infer harness: one client in a closed loop sends whole studies to
the program's `predict_mask` for `seconds`, then the output check.

A request is one study, its two modalities' (n, H, W, 1) arrays on the
host; it is timed until its mask probabilities are back on the host, as
the tester takes them (`.cpu().numpy()`). The studies cycle through a pool
that holds each slice count of the traffic once, each pass in a fresh
seeded order; set-up warms every count once. After the window, a seeded
sample of the served studies, the longest count among them, is run once
through the reference and compared.
"""

import gc
import time
import types

import numpy as np
import torch

from benchmark.harness import check, common, faults, program
from benchmark.harness.trace import Spans, Trace, profiler, shapes_profiler
from benchmark.reference.precision import set_precision
from benchmark.traffic import studies, weights


# requests under the short shapes profile after a traced window
SHAPE_REQUESTS = 2
# control.py's modes: the program as a run drives it (a short window), or
# the reference put in its place (faults.IN_PLACE)
MODES = ("sound", *faults.IN_PLACE)
# the CPU cut of an infer workload (tests/tiny.py): a few short studies at
# 32 x 32, and limits a little above what sound runs read there in float32
TINY_TRAFFIC = {"hw": [32, 32], "slices": [4, 7], "sample_from": 6, "sampled": 2}
TINY_CHECKS = {"volume_gap": 1e-4, "region_gap": 1e-4}


class Inputs:
    def __init__(self, workload, config, seed, device, bench_dir=common.BENCH_DIR):
        self.workload = workload
        self.seeds = common.seeds(seed)
        fields = common.model_fields(config, workload, self.seeds.conf)
        self.conf = program.experiment_config(fields)
        self.ref_conf = common.namespace(fields)
        self.reference = common.reference_model(config, bench_dir)
        self.device = device
        self.pool = studies.request_pool(workload["traffic"], self.seeds.studies, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.state = weights.make(self.reference, self.ref_conf, config["weights"],
                                  self.seeds.weights, device)

    def sample(self):
        """Which requests are kept for the check: `sampled` positions drawn
        from the first `sample_from`, and the first of the longest study."""
        t = self.workload["traffic"]
        rng = np.random.RandomState(self.seeds.sample)
        return set(rng.choice(t["sample_from"], size=t["sampled"], replace=False).tolist())


def reference_masks(inputs, kept):
    """The reference's masks of the kept studies, at the configuration's
    compute dtype (reference/precision.py)."""
    model = reference_model(inputs, inputs.ref_conf.compute_dtype)
    t = inputs.workload["traffic"]
    out = []
    for i, _ in kept:
        x1, x2 = (torch.from_numpy(a).to(inputs.device) for a in inputs.pool[i])
        out.append(model.predict_mask(t["modality_index"], [x1, x2]).cpu())
    return out


def reference_model(inputs, precision):
    model = inputs.reference(inputs.ref_conf)
    model.load_state_dict(inputs.state)
    return set_precision(model.to(inputs.device), precision).eval()


def unit_of_work(conf, workload, model_cls):
    """predict_mask over one slice on meta tensors, as a function that
    flops/count.py counts."""
    with torch.device("meta"):
        model = model_cls(conf).eval()
    x = torch.zeros((1, *conf.input_hw, 1), device="meta")
    return lambda: model.predict_mask(workload["traffic"]["modality_index"], [x, x])


def reading(mode, seed, seconds, workload, config, device, bench_dir=common.BENCH_DIR):
    """control.py's numbers of one seed: a window of `seconds` with the
    program, or with the reference in its place (faults.IN_PLACE)."""
    wrap = None
    if mode in faults.IN_PLACE:
        def wrap(predict):
            model = reference_model(Inputs(workload, config, seed, device, bench_dir),
                                    faults.IN_PLACE[mode])
            return lambda index, fusion, images, device: model.predict_mask(
                index, [torch.as_tensor(x, device=device) for x in images])
    res = run(seed, seconds, False, workload, config, time.perf_counter(), device, wrap,
              bench_dir)
    return res.numbers, {"requests": res.attempted}


def run(seed, seconds, trace, workload, config, t0, device, wrap_predict=None,
        bench_dir=common.BENCH_DIR):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    parts = {"start": time.perf_counter() - t0}
    inputs = Inputs(workload, config, seed, device, bench_dir)
    parts["inputs"] = time.perf_counter() - t0
    t = workload["traffic"]
    model = program.build_model(inputs.conf, inputs.state, device)
    parts["program"] = time.perf_counter() - t0
    predict = wrap_predict(model.predict_mask) if wrap_predict else model.predict_mask

    def request(i):
        x1, x2 = inputs.pool[i]
        return predict(t["modality_index"], t["fusion"], [x1, x2], device=device).cpu().numpy()

    for i in range(len(inputs.pool)):
        request(i)
    sync()
    setup_s = time.perf_counter() - t0
    parts["warmup"] = setup_s

    order = studies.request_order(len(inputs.pool), inputs.seeds.studies)
    keep = inputs.sample()
    longest = len(inputs.pool) - 1
    kept, latencies, slices, failed = [], [], 0, 0
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
            mask = request(i)
            latencies.append(time.perf_counter() - t_req)
        n = inputs.pool[i][0].shape[0]
        slices += n
        if mask.shape != (n,) + tuple(inputs.conf.input_hw) + (inputs.conf.num_masks + 1,) or \
                not np.isfinite(mask).all():
            failed += 1
        k = len(latencies) - 1
        if k in keep or (i == longest and all(j != longest for j, _ in kept)):
            kept.append((i, mask))
    sync()
    window_s = time.perf_counter() - start
    if prof:
        prof.stop()
    launches = program.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = shapes = None
    if prof:
        traced = Trace(prof, window_s, spans)
        shapes = shapes_profiler()
        shapes.start()
        for i in range(SHAPE_REQUESTS):
            request(i)
        sync()
        shapes.stop()
        shapes = Trace(shapes, None)
    del model, predict, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_masks(inputs, kept)
    nums = check.inference_numbers([m for _, m in kept], ref)
    correct, checks = check.verdict(nums, workload["checks"])
    return types.SimpleNamespace(
        correct=correct and failed == 0, checks=checks, numbers=nums, left_out=None,
        attempted=len(latencies), failed=failed, setup_s=setup_s, window_s=window_s,
        steps=len(latencies), slices=slices, latencies_s=latencies,
        memory_peak_bytes=peak, launches=launches, trace=traced, shapes=shapes,
        shape_units=SHAPE_REQUESTS, setup_parts=parts)
