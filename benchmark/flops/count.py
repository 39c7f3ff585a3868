"""Counts the operations of a cell's work on the plain reference, at the
cell's shapes, on the meta device (no data, no time): the unit of work
that the workload's harness kind gives (its `unit_of_work`: a training
batch of the workload's step calls, a served slice). FLOPs are 2 a
multiply-add, as torch.utils.flop_counter counts them; `conv` is the part
in convolutions (forward and backward). Optimizer updates are not counted.

    python benchmark/flops/count.py dafnet_chaos

prints, for each workload of that configuration, the counts that its
configuration file keeps under `flops`.
"""

import json
import os
import sys

from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402

CONV_OPS = ("convolution", "convolution_backward")


def counted(work):
    """{"total", "conv"} FLOPs of one call of `work`."""
    with FlopCounterMode(display=False) as counter:
        work()
    counts = counter.get_flop_counts().get("Global", {})
    total = sum(counts.values())
    conv = sum(v for k, v in counts.items() if str(k).split(".")[-1] in CONV_OPS)
    return {"total": int(total), "conv": int(conv)}


def count(name, bench_dir=common.BENCH_DIR):
    """{the workload's `flops` key: its counts} for each workload of the
    configuration `name` in the tree at `bench_dir`."""
    bench = common.load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    config = common.load_json(os.path.join(bench_dir, "configs", name + ".json"))
    model_cls = common.reference_model(config, bench_dir)
    out = {}
    for w in bench["workloads"]:
        if w["config"] != name:
            continue
        wl = common.load_json(os.path.join(bench_dir, "workloads", w["name"] + ".json"))
        conf = common.namespace(common.model_fields(config, wl, 0))
        kind = common.harness(wl["kind"], bench_dir)
        out[wl["flops"]] = counted(kind.unit_of_work(conf, wl, model_cls))
    return out


if __name__ == "__main__":
    print(json.dumps(count(sys.argv[1]), indent=1))
