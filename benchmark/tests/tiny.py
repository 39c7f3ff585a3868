"""A cell's files cut to a size that runs on the CPU, in float32, as its
files declare: the configuration file's `tiny` block sets the model's
fields (a nested group's keys over the group's own; for the 2-D models the
port's tiny_test_config sizes), and the harness kind's `TINY_TRAFFIC` and
`TINY_CHECKS` the traffic's parameters (a few short studies) and the
limits.

The cells' limits are set from readings at their own sizes in bfloat16 on
the chip (PERF.md); at the cut in float32 the program reads the reference
to round-off, so each kind holds limits of its own for it, a little above
what sound runs read there."""

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def cut(config, workload, bench_dir=common.BENCH_DIR):
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    m = config["model"]
    for k, v in config["tiny"].items():
        m[k] = dict(m[k], **v) if isinstance(v, dict) else v
    kind = common.harness(workload["kind"], bench_dir)
    workload["traffic"].update(kind.TINY_TRAFFIC)
    workload["checks"] = dict(kind.TINY_CHECKS)
    return config, workload


CELLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cells")


def files(name, bench_dir=common.BENCH_DIR):
    """(BENCHMARK.json or None, the workload entry, the workload file, the
    configuration file) of a cell of BENCHMARK.json, or of one kept in
    tests/cells/ (its workload file and, where configs/ lacks it, its
    configuration file): traffic that no cell runs yet, whose reference
    paths these tests still hold against the port."""
    path = os.path.join(CELLS, name + ".json")
    if not os.path.exists(path):
        return common.cell(name, bench_dir)
    workload = common.load_json(path)
    config_path = os.path.join(CELLS, workload["config"] + ".json")
    if not os.path.exists(config_path):
        config_path = os.path.join(bench_dir, "configs", workload["config"] + ".json")
    entry = {"name": name, "config": workload["config"], "chips": 1}
    return None, entry, workload, common.load_json(config_path)


def cell(name, bench_dir=common.BENCH_DIR):
    """files() of the cell, cut."""
    bench, entry, workload, config = files(name, bench_dir)
    config, workload = cut(config, workload, bench_dir)
    return bench, entry, workload, config
