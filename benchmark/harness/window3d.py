"""The window3d harness: one client in a closed loop sends whole
multi-sequence studies to the program's volumetric segmenter
(Cardiac3DSegmenter.predict, MONAI's sliding window through the
configuration's net) for `seconds`, then the output check.

A request is one study, a (1, D, H, W, C) float32 array on the host; it
is timed until its sigmoid probabilities, (1, D, H, W, outputs) float32,
are back on the host, in the client's own reused host array. The studies
cycle through a pool (traffic/volumes.py), each pass in a fresh seeded
order; set-up serves the first study of each shape in the pool once,
which runs every window batch and study shape that the window runs. The
run's units are the windows that serving each study takes, counted by
MONAI's rule (reference/<model>.py::window_starts), as the
configuration's flops count one window. After the window a seeded sample of the served
studies, and the first of the deepest, is run once through the
reference's own sliding window (reference/<model>.py::predict_volume)
and compared by infer3d's numbers (volume_gap, region_gap, and
mask_mismatch, printed only), over the outputs.

The configuration file's `serving` block gives the windows' overlap to
the reference; the program serves at its own (config.SWIN_UNETR_OVERLAP),
and the check compares the two.

The faults (control.py's modes, planted under the timed path): the
stitch shifted by one window stride or an axis mirrored (as infer3d's),
and three in the Swin blocks' window attention: the relative-position
bias read with its h and w offsets swapped, the shift mask dropped, and
the roll's sign flipped.
"""

import gc
import math
import sys
import time
import types

import numpy as np
import torch

from benchmark.harness import check, common, program
from benchmark.harness.infer3d import mirrored, volume_numbers
from benchmark.harness.trace import Spans, Trace, profiler
from benchmark.reference.precision import set_precision
from benchmark.traffic import studies, swin_weights, volumes
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter

# the CPU cut (tests/tiny.py): one study a little past the 64^3 window on
# two axes, so that it takes 1 x 2 x 2 windows, the last flush with the
# end and overlapping the first; limits a little above what sound runs
# read there in float32
TINY_TRAFFIC = {"depths": [64, 64], "repeat": 1, "hw": [66, 70], "sample_from": 1, "sampled": 1}
TINY_CHECKS = {"volume_gap": 1e-4, "region_gap": 1e-4}


def shifted(predict, stride):
    """A stitch shifted by one window stride along W."""
    return lambda *args: predict(*args).roll(stride[2], dims=3)


def _planted(plant):
    """A fault planted in the program's net before each request: `plant(net)`
    changes the net's modules in place, once."""
    def wrap(predict, stride):
        def faulty(net, volume):
            if not getattr(net, "_fault_planted", False):
                plant(net)
                net._fault_planted = True
            return predict(net, volume)
        return faulty
    return wrap


def _swap_bias_hw(net):
    """Each window attention's relative-position bias read with the h and w
    offsets swapped: index (dd * 13 + dh) * 13 + dw read as (dd * 13 + dw)
    * 13 + dh."""
    from multimodal_segmentation_torch.nn.swin_unetr import WindowAttention
    for m in net.modules():
        if isinstance(m, WindowAttention):
            i = m.relative_position_index
            m.relative_position_index = (i // 169) * 169 + (i % 13) * 13 + (i // 13) % 13


def _drop_mask(net):
    """The rolled blocks attend without the -100 between shift regions."""
    from multimodal_segmentation_torch.nn.swin_unetr import BasicLayer
    for m in net.modules():
        if isinstance(m, BasicLayer):
            m.mask = lambda size, device: None


def roll_flipped(predict, stride):
    """The rolled blocks roll their tokens by +3 on each axis and back by -3,
    where they roll by -3 and back by +3 (the shift mask as it was)."""
    def faulty(net, volume):
        roll = torch.roll
        torch.roll = lambda x, shifts, dims: roll(x, [-s for s in shifts], dims)
        try:
            return predict(net, volume)
        finally:
            torch.roll = roll
    return faulty


FAULTS = {"shifted": shifted, "mirrored": mirrored, "bias_hw_swapped": _planted(_swap_bias_hw),
          "mask_dropped": _planted(_drop_mask), "roll_flipped": roll_flipped}
MODES = ("sound", "control", "float32", *FAULTS)


def _reference_module(inputs):
    return sys.modules[inputs.reference.__module__]


class Inputs:
    def __init__(self, workload, config, seed, device, bench_dir=common.BENCH_DIR):
        self.workload = workload
        self.overlap = config["serving"]["overlap"]
        self.seeds = common.seeds(seed)
        fields = common.model_fields(config, workload, self.seeds.conf)
        self.conf = program.experiment_config(fields)
        self.ref_conf = common.namespace(fields)
        self.reference = common.reference_model(config, bench_dir)
        self.device = device
        t = workload["traffic"]
        self.pool = volumes.request_pool(t, self.seeds.studies, device)
        roi = tuple(self.ref_conf.volume_shape[:3])
        self.stride = tuple(r if r == s else max(int(r * (1 - self.overlap)), 1)
                            for r, s in zip(roi, self.pool[0].shape[1:4]))
        # the windows that serving each study of the pool takes: the run's
        # unit of work
        starts = _reference_module(self).window_starts
        self.windows = [math.prod(len(a) for a in starts(
            [max(s, r) for s, r in zip(v.shape[1:4], roi)], roi, self.overlap)) for v in self.pool]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.state = swin_weights.make_weights(self.reference, self.ref_conf, t,
                                               self.seeds.weights, device)

    def sample(self):
        """Which requests are kept for the check: `sampled` positions drawn
        from the first `sample_from`, and the first of the deepest study."""
        t = self.workload["traffic"]
        rng = np.random.RandomState(self.seeds.sample)
        return set(rng.choice(t["sample_from"], size=t["sampled"], replace=False).tolist())

    def deepest(self):
        depths = [v.shape[1] for v in self.pool]
        return depths.index(max(depths))


def reference_probabilities(inputs, kept, precision):
    """The reference's probabilities of the kept studies, (1, D, H, W,
    outputs) host arrays, at `precision`, in window batches of the
    configuration's batch size."""
    model = inputs.reference(inputs.ref_conf)
    model.load_state_dict(inputs.state)
    model = set_precision(model.to(inputs.device), precision).eval()
    predict = _reference_module(inputs).predict_volume
    out = [predict(model, inputs.pool[i][0], inputs.ref_conf.batch_size, inputs.device,
                   inputs.overlap)[None] for i in kept]
    del model
    return out


def unit_of_work(conf, workload, model_cls):
    """One window through the reference on meta tensors, as a function
    that flops/count.py counts."""
    with torch.device("meta"):
        model = model_cls(conf).eval()
    x = torch.zeros((1, conf.volume_shape[3]) + tuple(conf.volume_shape[:3]), device="meta")
    return lambda: model(x)


def reading(mode, seed, seconds, workload, config, device, bench_dir=common.BENCH_DIR):
    """control.py's numbers of one seed, as infer3d's: sound and the faults
    a window of `seconds` (the faults planted under the timed path);
    control and float32 the reference at that precision against the
    reference at the configuration's, over the studies a run checks."""
    if mode in ("control", "float32"):
        inputs = Inputs(workload, config, seed, device, bench_dir)
        kept = sorted(inputs.sample() | {inputs.deepest()})
        got = reference_probabilities(inputs, kept, "fp8" if mode == "control" else "float32")
        ref = reference_probabilities(inputs, kept, inputs.ref_conf.compute_dtype)
        return volume_numbers(got, ref), {"studies": [list(inputs.pool[i].shape) for i in kept]}
    wrap = FAULTS.get(mode)
    res = run(seed, seconds, False, workload, config, time.perf_counter(), device, wrap, bench_dir)
    return res.numbers, {"requests": res.attempted}


def run(seed, seconds, trace, workload, config, t0, device, wrap_predict=None,
        bench_dir=common.BENCH_DIR):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    parts = {"start": time.perf_counter() - t0}
    inputs = Inputs(workload, config, seed, device, bench_dir)
    parts["inputs"] = time.perf_counter() - t0
    segmenter = Cardiac3DSegmenter(inputs.conf, device=device)
    net, _ = segmenter.init(state_dict=inputs.state)
    parts["program"] = time.perf_counter() - t0
    predict = segmenter.predict
    if wrap_predict is not None:
        predict = wrap_predict(predict, inputs.stride)

    # the client's own host array, as large as the largest answer
    outputs = inputs.conf.num_masks
    host = np.zeros(max(v[0, ..., 0].size for v in inputs.pool) * outputs, np.float32)

    def request(i):
        probs = predict(net, inputs.pool[i])
        out = host[:probs.numel()].reshape(probs.shape)
        torch.from_numpy(out).copy_(probs)
        return out

    # one study of each shape in the pool runs every window batch and study
    # shape that the window runs
    shapes = {}
    for i, v in enumerate(inputs.pool):
        shapes.setdefault(v.shape, i)
    for i in shapes.values():
        request(i)
    sync()
    setup_s = time.perf_counter() - t0
    parts["warmup"] = setup_s

    order = studies.request_order(len(inputs.pool), inputs.seeds.studies)
    keep = inputs.sample()
    deepest = inputs.deepest()
    kept, latencies, windows, failed = [], [], 0, 0
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
        windows += inputs.windows[i]
        if probs.shape != inputs.pool[i].shape[:4] + (outputs,) or not np.isfinite(probs).all():
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
        # the windows served count as the run's units (`slices` to the
        # readers), as the configuration's flops count one window
        steps=len(latencies), slices=windows, latencies_s=latencies,
        memory_peak_bytes=peak, launches=launches, trace=traced, shapes=None, shape_units=0,
        setup_parts=parts, model_conf=inputs.ref_conf)

