"""Each cell driven on the CPU at the tiny sizes with the kernels' plain
versions: the result line has the contract's shape and every metric is
found by name; a cell, configuration and metric added as files alone are
picked up, and so are a model's reference and a harness kind; the FLOP
counts are the configuration's; without a card the run prints no result.

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

from benchmark import control, run
from benchmark.flops import count
from benchmark.harness import common
from benchmark.tests import tiny

BENCH = common.load_json(os.path.join(common.REPO, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(name, trace, bench_dir=common.BENCH_DIR, seconds=1.0):
    torch.set_num_threads(1)
    bench, entry, workload, config = tiny.cell(name, bench_dir=bench_dir)
    res = common.harness(workload["kind"], bench_dir).run(
        tiny.SEED, seconds, trace, workload, config, time.perf_counter(), tiny.CPU,
        bench_dir=bench_dir)
    return bench, res, run.result(res, bench, name, trace, workload, config, "cpu",
                                  entry["chips"], bench_dir)


def _copy(tmp_path):
    """(the root, the benchmark directory) of a copy of the benchmark's
    files and BENCHMARK.json."""
    root = tmp_path / "repo"
    shutil.copytree(common.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(common.REPO, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root, root / "benchmark"


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
    root, bench_dir = _copy(tmp_path)
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


# a throwaway model and serving kind, each under a name that no file of the
# benchmark holds: the reference module subclasses DAFNet and counts the
# models built from it; the kind is the infer kind under another name
OKAPI_REFERENCE = '''"""A throwaway reference model: DAFNet, counting its instances."""

from benchmark.reference.models import DAFNet

BUILT = []


class MODEL(DAFNet):
    def __init__(self, conf):
        super().__init__(conf)
        BUILT.append(conf)
'''
OKAPI_KIND = '''"""A throwaway serving kind: the infer kind under another name."""

from benchmark.harness.infer import (  # noqa: F401
    MODES, TINY_CHECKS, TINY_TRAFFIC, reading, run, unit_of_work)
'''


def test_added_model_and_kind_are_files_alone(tmp_path):
    """A throwaway serving cell whose reference model and harness kind are
    new files, with its configuration (and `tiny` block), workload and
    BENCHMARK.json entries, in a copy of the benchmark's files: run at the
    CPU cut through the new kind with the new reference, correct, with the
    serving cell's latencies and set-up; its FLOPs counted through the
    kind on the new reference."""
    root, bench_dir = _copy(tmp_path)
    for d, dirs, files in os.walk(common.BENCH_DIR):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for f in files:
            path = os.path.join(d, f)
            if path != os.path.abspath(__file__):
                assert "okapi" not in open(path, errors="replace").read().lower(), path
    (bench_dir / "reference" / "okapi.py").write_text(OKAPI_REFERENCE)
    (bench_dir / "harness" / "okapi_serve.py").write_text(OKAPI_KIND)
    config = common.load_json(os.path.join(common.BENCH_DIR, "configs", "dafnet_chaos.json"))
    config["reference"] = "okapi"
    (bench_dir / "configs" / "okapi_chaos.json").write_text(json.dumps(config))
    workload = common.load_json(os.path.join(common.BENCH_DIR, "workloads",
                                             "dafnet-infer-volumes.json"))
    workload.update(config="okapi_chaos", kind="okapi_serve",
                    traffic=dict(workload["traffic"], name="okapi_studies"))
    (bench_dir / "workloads" / "okapi-serve.json").write_text(json.dumps(workload))
    bench = common.load_json(os.path.join(common.REPO, "BENCHMARK.json"))
    bench["configs"].append(dict(bench["configs"][0], name="okapi_chaos",
                                 file="benchmark/configs/okapi_chaos.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="okapi-serve",
                                   config="okapi_chaos", traffic="okapi_studies"))
    for m in bench["end_to_end"]:
        if m["name"] in ("infer_volume_ms_p50", "infer_volume_ms_p95"):
            m["workloads"].append("okapi-serve")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    model_cls = common.reference_model(config, str(bench_dir))
    okapi = sys.modules[model_cls.__module__]
    assert okapi.__file__ == str(bench_dir / "reference" / "okapi.py")
    _, res, out = _run("okapi-serve", trace=True, bench_dir=str(bench_dir))
    assert okapi.BUILT, "the run built no model of the new reference"
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}
    assert set(res.checks) == set(common.harness("okapi_serve", str(bench_dir)).TINY_CHECKS)
    e2e = run.result(res, bench, "okapi-serve", False, *tiny.cell(
        "okapi-serve", bench_dir=str(bench_dir))[2:], "cpu", 1, str(bench_dir))["metrics"]
    assert set(e2e) == {"infer_volume_ms_p50", "infer_volume_ms_p95", "setup_s"}
    assert all(v["value"] > 0 for v in e2e.values())

    built = len(okapi.BUILT)
    flops = count.count("okapi_chaos", str(bench_dir))
    assert len(okapi.BUILT) == built + 1
    assert flops == {"slice_max": config["flops"]["slice_max"]}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_flop_counts_are_the_configuration_s(name):
    config = common.load_json(os.path.join(common.BENCH_DIR, "configs", name + ".json"))
    counts = count.count(name)
    assert counts and counts == {k: config["flops"][k] for k in counts}


@pytest.mark.parametrize("name", ["dafnet-train-expert", "dafnet-train-automated",
                                  "mmsdnet-train"])
def test_kept_training_cells_flop_counts_are_the_configuration_s(name):
    """The train kind's unit of work, at the full sizes of the training
    cells kept in tests/cells/, counts what their configurations hold."""
    _, _, workload, config = tiny.files(name)
    conf = common.namespace(common.model_fields(config, workload, 0))
    work = common.harness(workload["kind"]).unit_of_work(conf, workload,
                                                         common.reference_model(config))
    assert count.counted(work) == config["flops"][workload["flops"]]


def test_control_refuses_a_mode_the_kind_lacks():
    with pytest.raises(SystemExit, match="half_batch"):
        control.main(["--workload", "dafnet-infer-volumes", "--mode", "sound,half_batch",
                      "--seeds", "1", "--device", "cpu"])


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, os.path.join(common.BENCH_DIR, "run.py"),
                           "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=common.REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
