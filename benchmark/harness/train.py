"""The train harness: the program's training steps on the executor's own
batch iterator, for `seconds`, then the output check.

Set-up builds one train state from the seed's weights and drives it
through its first three steps with the window's own call and feed; once
the window has closed the reference follows the first (all three where a
check reads the gradients or the parameters' change). The
workload file gives the step calls a batch makes (`steps`: [method, batch
part, noise kind]), the noise of each kind (`noise`), the losses compared
(`compare_losses`), the extra warm-up steps and the limits (`checks`).
"""

import gc
import time
import types

import numpy as np
import torch

from benchmark.harness import check, common, faults, program
from benchmark.harness.trace import Spans, Trace, profiler, shapes_profiler
from benchmark.reference.batches import Paired, training_batches
from benchmark.reference.train import Trainer
from benchmark.traffic import noise as noise_mod
from benchmark.traffic import studies, weights

CHECKED_STEPS = 3
# batches under the short shapes profile after a traced window
SHAPE_STEPS = 2
# control.py's modes: the program's first steps, the reference in its
# place (faults.IN_PLACE), or the program with half of each batch left out
MODES = ("sound", *faults.IN_PLACE, "half_batch")
# the CPU cut of a train workload (tests/tiny.py): 3 short studies at
# 32 x 32, batch 2, and a limit a little above what sound runs read there
# in float32
TINY_TRAFFIC = {"hw": [32, 32], "slices": [4, 7], "studies": 3, "batch": 2}
TINY_CHECKS = {"stats_gap": 1e-3}


class Inputs:
    """What the benchmark makes from the seed and hands to both sides: the
    studies, the weights, the program's conf and the reference's view of
    it, and the generator of the step noise."""

    def __init__(self, workload, config, seed, device, bench_dir=common.BENCH_DIR):
        self.workload = workload
        self.seeds = common.seeds(seed)
        fields = common.model_fields(config, workload, self.seeds.conf)
        self.conf = program.experiment_config(fields)
        self.ref_conf = common.namespace(fields)
        self.reference = common.reference_model(config, bench_dir)
        self.device = device
        self.studies = studies.training_studies(workload["traffic"], self.seeds.studies, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.state = weights.make(self.reference, self.ref_conf, config["weights"],
                                  self.seeds.weights, device)
        self.noise_gen = torch.Generator(device=device).manual_seed(self.seeds.noise)

    def noise(self):
        conf = self.conf
        return {kind: noise_mod.draw(parts, self.noise_gen, conf.batch_size, conf.num_z,
                                     conf.rotation_range)
                for kind, parts in self.workload["noise"].items()}


def _calls(target, batch, nz, calls):
    metrics = {}
    for method, part, kind in calls:
        out = getattr(target, method)(batch[part], nz[kind])
        metrics.update({k: v.detach() for k, v in out.items()})
    return metrics


class ProgramSide:
    """The program's train state, steps and batch iterator; `step()` runs
    one batch through the workload's step calls."""

    def __init__(self, inputs, wrap_steps=None):
        self.inputs = inputs
        self.model, self.ts, steps, self.batches = program.train_setup(
            inputs.conf, inputs.state, inputs.studies, inputs.seeds.numpy, inputs.device)
        self.steps = wrap_steps(steps) if wrap_steps else steps
        self.names = {id(p): n for n, p in self.model.named_parameters()}
        self.calls = inputs.workload["steps"]
        self.spans = Spans(False)

    def step(self):
        spans = self.spans
        with spans("data_wait"):
            batch = next(self.batches)
        with spans("noise"):
            nz = self.inputs.noise()
        metrics = {}
        with spans("step"):
            for method, part, kind in self.calls:
                _, m = getattr(self.steps, method)(self.ts, batch[part], nz[kind])
                metrics.update(m)
        return metrics, nz

    def first_gradients(self):
        return check.first_gradients(program.optimizers(self.model, self.ts), self.names)

    def parameters(self):
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def running_means(self):
        return running_means(self.model)


def running_means(model):
    """The BatchNorm running means a model holds, cloned."""
    return {n: b.detach().clone() for n, b in model.named_buffers() if n.endswith("running_mean")}


def follow(inputs, noises, precision=None, full=True):
    """The reference's readings over a step a noise in `noises`, from the
    same weights, the batches it assembles itself from the same studies, and
    `noises`; at the configuration's compute dtype unless `precision` names
    another policy (reference/precision.py). Without `full`, the first
    step's losses and running means alone."""
    dev = inputs.device
    trainer = Trainer(inputs.reference, inputs.ref_conf, inputs.state, dev,
                      precision or inputs.ref_conf.compute_dtype)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    np.random.seed(inputs.seeds.numpy)
    batches = training_batches(inputs.ref_conf, lambda: Paired(*inputs.studies))
    out = {"metrics": []}
    for i, nz in enumerate(noises if full else noises[:1]):
        batch = {part: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
                 for part, d in next(batches).items()}
        out["metrics"].append(_calls(trainer, batch, nz, inputs.workload["steps"]))
        if i == 0:
            out["stats"] = running_means(trainer.model)
            if full:
                out["grads"] = check.first_gradients(
                    {k: (trainer.opt[k], trainer.optimizers[k]) for k in trainer.opt}, names)
    if full:
        out["after"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    return out


def first_steps(side, full=True):
    """The first CHECKED_STEPS steps of `side`: their metrics and noise and
    the BatchNorm running means after the first; with `full`, the first
    gradients too and the parameters after them all."""
    out, noises = {"metrics": []}, []
    for i in range(CHECKED_STEPS):
        m, nz = side.step()
        out["metrics"].append(m)
        noises.append(nz)
        if i == 0:
            out["stats"] = side.running_means()
            if full:
                out["grads"] = side.first_gradients()
    if full:
        out["after"] = side.parameters()
    return out, noises


def numbers(inputs, prog, ref):
    if "after" in prog:
        start = {k: inputs.state[k] for k in prog["after"]}
        prog, ref = dict(prog, start=start), dict(ref, start=start)
    return check.training_numbers(prog, ref, inputs.workload["compare_losses"])


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def unit_of_work(conf, workload, model_cls):
    """One batch of the workload's step calls on meta tensors, as a
    function that flops/count.py counts; the optimizers' updates are left
    out."""
    dev = torch.device("meta")
    trainer = Trainer(model_cls, conf, None, dev)
    trainer._adam = lambda name, grads: None
    B, (H, W) = conf.batch_size, conf.input_hw
    K = conf.n_pairs if conf.automatedpairing else 1
    nm = conf.num_masks
    x1, x2 = ("x1_pairs", "x2_pairs") if conf.automatedpairing else ("x1", "x2")
    shapes = {x1: (B, H, W, K), x2: (B, H, W, K), "m1": (B, H, W, nm), "m2": (B, H, W, nm),
              "dm1": (B, H, W, nm), "dm2": (B, H, W, nm), "dx1": (B, H, W, 1),
              "dx2": (B, H, W, 1), "dm": (B, H, W, nm)}
    batch = {k: torch.zeros(v, device=dev) for k, v in shapes.items()}
    parts = {"sup": batch, "unsup": batch, "disc": batch}

    def work():
        gen = torch.Generator(device="cpu")
        for method, part, kind in workload["steps"]:
            nz = noise_mod.draw(workload["noise"][kind], gen, B, conf.num_z, conf.rotation_range)
            nz = {k: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
                  for k, v in nz.items()}
            getattr(trainer, method)(dict(parts[part]), nz)
    return work


def reading(mode, seed, seconds, workload, config, device, bench_dir=common.BENCH_DIR):
    """control.py's numbers of one seed over the first three steps (no
    window: `seconds` is not used), from the program, the program with a
    fault (faults.STEP_FAULTS) or the reference in its place
    (faults.IN_PLACE), each against the reference."""
    inputs = Inputs(workload, config, seed, device, bench_dir)
    if mode in faults.IN_PLACE:
        noises = [inputs.noise() for _ in range(CHECKED_STEPS)]
        prog = follow(inputs, noises, precision=faults.IN_PLACE[mode])
    else:
        side = ProgramSide(inputs, faults.STEP_FAULTS.get(mode))
        prog, noises = first_steps(side)
        del side
    _free(device)
    return numbers(inputs, prog, follow(inputs, noises))


def run(seed, seconds, trace, workload, config, t0, device, wrap_steps=None,
        bench_dir=common.BENCH_DIR):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    parts = {"start": time.perf_counter() - t0}
    inputs = Inputs(workload, config, seed, device, bench_dir)
    parts["inputs"] = time.perf_counter() - t0
    side = ProgramSide(inputs, wrap_steps)
    parts["program"] = time.perf_counter() - t0
    # the numbers compared read the first step's forward alone, or the
    # gradients and the parameters' change too
    full = any(k not in check.FIRST_STEP for k in workload["checks"])
    prog, noises = first_steps(side, full)
    parts["checked_steps"] = time.perf_counter() - t0
    for _ in range(workload["warmup_steps"]):
        side.step()
    sync()
    setup_s = time.perf_counter() - t0
    parts["warmup"] = setup_s

    program.reset_launch_counts()
    prof = profiler() if trace else None
    if prof:
        side.spans = Spans()
        prof.start()
    losses = []
    sync()
    start = time.perf_counter()
    while True:
        m, _ = side.step()
        losses.append(torch.stack([v.detach().float() for v in m.values()]))
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start
    if prof:
        prof.stop()
    launches = program.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n_steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).any(dim=1).sum())
    traced = shapes = None
    if prof:
        traced = Trace(prof, window_s, side.spans)
        shapes = shapes_profiler()
        shapes.start()
        for _ in range(SHAPE_STEPS):
            side.step()
        sync()
        shapes.stop()
        shapes = Trace(shapes, None)
    del side, losses, prof
    _free(device)

    ref = follow(inputs, noises, full=full)
    nums, where = numbers(inputs, prog, ref)
    correct, checks = check.verdict(nums, workload["checks"])
    return types.SimpleNamespace(
        correct=correct and failed == 0, checks=checks, numbers=nums,
        left_out=where["left_out"],
        attempted=n_steps, failed=failed, setup_s=setup_s, window_s=window_s,
        steps=n_steps, slices=n_steps * inputs.conf.batch_size, latencies_s=None,
        memory_peak_bytes=peak, launches=launches, trace=traced, shapes=shapes,
        shape_units=SHAPE_STEPS, setup_parts=parts)
