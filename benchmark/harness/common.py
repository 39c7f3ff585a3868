"""What every run shares: the files of a cell, the seeds, the caches, the
readers of the metrics, and the result line.

A cell is found by name: BENCHMARK.json names its configuration and its
traffic; benchmark/workloads/<cell>.json holds the harness kind, the
traffic's parameters and the limits of its output check;
benchmark/configs/<config>.json the configuration as run. Code is found by
name too, each from the files of the tree at `bench_dir`: each metric
<name> is read by benchmark/metrics/<name>.py, a harness kind is
benchmark/harness/<kind>.py, and a configuration's plain reference model is
benchmark/reference/<reference>.py. Nothing here names a cell, a
configuration, a model, a kind or a metric.
"""

import importlib.util
import json
import os
import sys
import types
import zlib

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
# top-level modules the run's process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_segmentation_tpu")


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    root = os.path.join(BENCH_DIR, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "triton")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell(name, bench_dir=BENCH_DIR):
    """(the BENCHMARK.json dict, its workload entry, the workload file, the
    configuration file) of cell `name`."""
    bench = load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    workload = load_json(os.path.join(bench_dir, "workloads", name + ".json"))
    config = load_json(os.path.join(bench_dir, "configs", entry["config"] + ".json"))
    if workload["config"] != entry["config"] or workload["traffic"]["name"] != entry["traffic"]:
        raise SystemExit("workloads/%s.json disagrees with BENCHMARK.json" % name)
    return bench, entry, workload, config


def seeds(seed):
    """The derived seeds of a run: torch generators take the whole number;
    numpy's and the program's conf.seed take 31-bit words from it."""
    words = [int(w) % 2 ** 31 for w in np.random.SeedSequence(abs(int(seed))).generate_state(4)]
    base = abs(int(seed)) % 2 ** 62
    return types.SimpleNamespace(studies=base, weights=base + 1, noise=base + 2,
                                 conf=words[0], numpy=words[1], sample=words[2])


def namespace(fields):
    """The configuration file's `model` fields as attributes (nested groups
    too), with input_hw as the program derives it: the reference's view."""
    ns = types.SimpleNamespace(**{k: types.SimpleNamespace(**v) if isinstance(v, dict) else v
                                  for k, v in fields.items()})
    h, w, _ = ns.input_shape
    ns.input_hw = (int(h / ns.image_downsample), int(w / ns.image_downsample))
    return ns


def model_fields(config, workload, seed):
    """The configuration as a cell runs it: the configuration file's
    `model` fields, the workload's own (e.g. the pairing mode) over them,
    and the run's seed."""
    return dict(config["model"], **workload.get("model", {}), seed=seed)


def metric_names(bench, name, trace):
    """The cell's metrics: its end-to-end ones, or with `trace` its
    per-layer ones; each applies where its `workloads` lists the cell, or
    everywhere without that key."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def _module(bench_dir, folder, name):
    """benchmark/<folder>/<name>.py of the tree at `bench_dir`, loaded from
    its file once a process, so that a copy of the tree brings its own."""
    path = os.path.abspath(os.path.join(bench_dir, folder, name + ".py"))
    key = "benchmark_%s_%s_%08x" % (folder, name.replace(".", "_"), zlib.crc32(path.encode()))
    if key not in sys.modules:
        if not os.path.exists(path):
            raise SystemExit("no %s" % path)
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def reader(metric, bench_dir=BENCH_DIR):
    return _module(bench_dir, "metrics", metric).read


def harness(kind, bench_dir=BENCH_DIR):
    """The harness module of a workload's `kind`. It gives `run` (set-up,
    the measured window and the output check), `reading` and `MODES` (the
    readings that set the check's limits, control.py), `unit_of_work` (the
    work that flops/count.py counts) and the CPU cut of its workloads,
    `TINY_TRAFFIC` and `TINY_CHECKS` (tests/tiny.py)."""
    return _module(bench_dir, "harness", kind)


def reference_model(config, bench_dir=BENCH_DIR):
    """The plain reference's model class of a configuration file: `MODEL`
    of the module that its `reference` key names, by default its model's
    name."""
    return _module(bench_dir, "reference", config.get("reference",
                                                      config["model"]["model"])).MODEL


def read_metrics(metrics, ctx, bench_dir=BENCH_DIR):
    out = {}
    for m in metrics:
        value = reader(m["name"], bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result, checks):
    """The compared numbers as the last lines on standard error, and the
    result as the last line on standard output, the checks last in it."""
    for k, c in checks.items():
        print("check %s = %r (limit %r)" % (k, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
