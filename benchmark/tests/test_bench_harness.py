"""Each cell driven on the CPU at the tiny sizes with the kernels' plain
versions: the result line has the contract's shape and every metric is
found by name; a cell, configuration and metric added as files alone are
picked up; without a card the run prints no result.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import common, infer, train
from benchmark.tests import tiny

CELLS = [w["name"] for w in common.load_json(os.path.join(common.REPO, "BENCHMARK.json"))
         ["workloads"]]
HARNESSES = {"train": train, "infer": infer}


def _run(name, trace, bench_dir=common.BENCH_DIR, seconds=1.0):
    torch.set_num_threads(1)
    bench, entry, workload, config = tiny.cell(name, bench_dir=bench_dir)
    res = HARNESSES[workload["kind"]].run(tiny.SEED, seconds, trace, workload, config,
                                            time.perf_counter(), tiny.CPU)
    return bench, res, run.result(res, bench, name, trace, workload, config, "cpu",
                                  entry["chips"], bench_dir)


@pytest.mark.parametrize("name", CELLS)
def test_cell_result_line(name):
    bench, res, out = _run(name, trace=True)
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: only the host's readings are there
    names = [m["name"] for m in common.metric_names(bench, name, True)]
    assert set(out["metrics"]) <= set(names)
    for m in names + [m["name"] for m in common.metric_names(bench, name, False)]:
        assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics", m + ".py")), m
    e2e = run.result(res, bench, name, False, *tiny.cell(name)[2:], "cpu", 1)["metrics"]
    assert set(e2e) == {m["name"] for m in common.metric_names(bench, name, False)}
    assert all(v["value"] > 0 for v in e2e.values())
    line = json.dumps({**out, "checks": res.checks})
    assert json.loads(line)["checks"] == res.checks


def test_added_cell_config_and_metric_are_files_alone(tmp_path):
    """A throwaway training cell (the expert-pairing traffic kept in
    tests/cells/), a configuration and a per-layer metric, each added as a
    file and a BENCHMARK.json entry in a copy of the benchmark's files:
    found by name, with no code changed; the training metrics whose readers
    are already there are listed for it as entries alone."""
    root = tmp_path / "repo"
    bench_dir = root / "benchmark"
    for sub in ("workloads", "configs", "metrics"):
        shutil.copytree(os.path.join(common.BENCH_DIR, sub), bench_dir / sub)
    bench = common.load_json(os.path.join(common.REPO, "BENCHMARK.json"))
    config = common.load_json(os.path.join(common.BENCH_DIR, "configs", "dafnet_chaos.json"))
    (bench_dir / "configs" / "dafnet_copy.json").write_text(json.dumps(config))
    workload = common.load_json(os.path.join(tiny.CELLS, "dafnet-train-expert.json"))
    workload.update(config="dafnet_copy", traffic=dict(workload["traffic"], name="copy"))
    (bench_dir / "workloads" / "throwaway.json").write_text(json.dumps(workload))
    (bench_dir / "metrics" / "steps_in_window.train.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench["configs"].append(dict(bench["configs"][0], name="dafnet_copy",
                                 file="benchmark/configs/dafnet_copy.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="throwaway",
                                   config="dafnet_copy", traffic="copy"))
    bench["end_to_end"].append({"name": "train_slices_per_s", "unit": "slices/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["throwaway"]})
    for name in ("steps_in_window.train", "data_wait_ms.train", "step_mfu.train"):
        bench["per_layer"].append({"name": name, "unit": "x", "better": "higher",
                                   "source": "host_clock", "layer": "train step",
                                   "moves": "train_slices_per_s", "workloads": ["throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, res, out = _run("throwaway", trace=True, bench_dir=str(bench_dir))
    assert out["correct"] is True and out["attempted"] > 0
    assert out["metrics"]["steps_in_window.train"]["value"] == res.steps > 0
    assert out["metrics"]["data_wait_ms.train"]["value"] > 0
    e2e = run.result(res, bench, "throwaway", False, *tiny.cell("throwaway", bench_dir=str(
        bench_dir))[2:], "cpu", 1, str(bench_dir))["metrics"]
    assert set(e2e) == {"train_slices_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in e2e.values())


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, os.path.join(common.BENCH_DIR, "run.py"),
                           "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=common.REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
