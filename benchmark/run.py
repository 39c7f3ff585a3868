"""Runs one cell of the benchmark of the PyTorch/CUDA port on one NVIDIA
GPU and prints its result as the last line of standard output:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the metrics are the cell's end-to-end ones; with --trace 1
its per-layer ones, read from a torch.profiler window over the measured
window, with the device's busy seconds and a breakdown. Set-up (imports,
CUDA, the kernel library, the studies, weights and model, the first steps
or requests) counts from the start of this script.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(res, workload, config):
    """What the metric readers read: the run's readings, the trace, and the
    cell's operation counts."""
    return types.SimpleNamespace(**vars(res), workload=workload,
                                 flops=config["flops"][workload["flops"]])


def result(res, bench, name, trace, workload, config, kind, chips, bench_dir=common.BENCH_DIR):
    """The result line of a run (without its checks, which common.emit puts
    last): the cell's metrics by their readers, and the device."""
    metrics = common.read_metrics(common.metric_names(bench, name, trace),
                                  context(res, workload, config), bench_dir)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res.memory_peak_bytes}
    out = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
        out["breakdown"] = res.trace.breakdown()
    return out


def main(argv=None):
    args = parse(argv)
    common.cache_dirs()
    bench, entry, workload, config = common.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print("needs %d CUDA device(s), found %d" % (
            entry["chips"], torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness = importlib.import_module("benchmark.harness." + workload["kind"])
    res = harness.run(args.seed, args.seconds, bool(args.trace), workload, config, T0,
                     torch.device("cuda", 0))
    found = common.forbidden_modules()
    if found:
        print("the run's process holds %s" % ", ".join(found), file=sys.stderr)
        return 3
    print("set-up, s from the start at the end of each part: %s" % json.dumps(res.setup_parts),
          file=sys.stderr)
    print("launches in the window: %s" % res.launches, file=sys.stderr)
    if res.left_out is not None:
        print("leaves left out of the gradient and change gaps (%d): %s"
              % (len(res.left_out), json.dumps(res.left_out)), file=sys.stderr)
    out = result(res, bench, args.workload, args.trace, workload, config,
                 torch.cuda.get_device_name(0), entry["chips"])
    common.emit(out, res.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
