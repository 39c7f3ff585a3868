"""A cell's files cut to the port's tiny_test_config sizes (32 x 32 inputs,
batch 2, UNet filters 4 and depth 2, discriminators of 4 filters and 2
blocks) and to a few short studies, for runs on the CPU, in float32.

The cells' limits are set from readings at their own sizes in bfloat16 on
the chip (PERF.md); at this size in float32 the program reads the
reference to round-off, so the cut holds limits of its own
(TINY_CHECKS), a little above what sound runs read here."""

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
TINY_CHECKS = {"train": {"stats_gap": 1e-3},
               "infer": {"volume_gap": 1e-4, "region_gap": 1e-4}}


def cut(config, workload, compute_dtype="float32"):
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    m = config["model"]
    m.update(input_shape=[32, 32, 1], batch_size=2, compute_dtype=compute_dtype,
             anatomy_encoder=dict(m["anatomy_encoder"], downsample=2, filters=4),
             d_mask_params=dict(m["d_mask_params"], filters=4, downsample_blocks=2),
             d_image_params=dict(m["d_image_params"], filters=4, downsample_blocks=2))
    workload["checks"] = TINY_CHECKS[workload["kind"]]
    t = workload["traffic"]
    t.update(hw=[32, 32], slices=[4, 7])
    if "studies" in t:
        t.update(studies=3, batch=2)
    if "sample_from" in t:
        t.update(sample_from=6, sampled=2)
    return config, workload


CELLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cells")


def cell(name, compute_dtype="float32", bench_dir=common.BENCH_DIR):
    """A cell of BENCHMARK.json, or one kept in tests/cells/ (its workload
    file and, where configs/ lacks it, its configuration file): traffic
    that no cell runs yet, whose reference paths these tests still hold
    against the port."""
    path = os.path.join(CELLS, name + ".json")
    if not os.path.exists(path):
        bench, entry, workload, config = common.cell(name, bench_dir)
        config, workload = cut(config, workload, compute_dtype)
        return bench, entry, workload, config
    workload = common.load_json(path)
    config_path = os.path.join(CELLS, workload["config"] + ".json")
    if not os.path.exists(config_path):
        config_path = os.path.join(bench_dir, "configs", workload["config"] + ".json")
    entry = {"name": name, "config": workload["config"], "chips": 1}
    config, workload = cut(common.load_json(config_path), workload, compute_dtype)
    return None, entry, workload, config
