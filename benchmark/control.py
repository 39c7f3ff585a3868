"""Readings that set the limits of a cell's output check, on the chip at
the cell's own size; the benchmark's own runs never run this.

    python benchmark/control.py --workload <cell> --mode <mode>[,<mode>...] --seeds 1,2,3

Modes, each printing one JSON line a seed with every number of
harness/check.py (and, for training, each part's worst leaf, each part's
reference gradient norm and the leaves left out); the workload's harness
kind reads them (its `reading`) and names the modes it has (`MODES`):
  sound       the program as a run drives it (training: its first three
              steps, no window; inference: a short window of --seconds)
  control     the reference in fp8 (reference/precision.py) put in the
              program's place: the nearest precision below the
              configurations' bfloat16
  float32     the reference in float32 in the program's place: what the
              configurations' bfloat16 itself costs, for the record
  half_batch  (training) the program with half of each batch left out
Every mode is compared with the reference at the configuration's compute
dtype, as a run is.
"""

import argparse
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   help="comma-separated: sound, control, float32, half_batch (the kind's MODES)")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="FIELD=JSON",
                   help="run the program with a configuration field changed (a witness)")
    args = p.parse_args(argv)
    _, _, workload, config = common.cell(args.workload)
    kind = common.harness(workload["kind"])
    for item in args.set:
        k, v = item.split("=", 1)
        workload["model"][k] = json.loads(v)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modes = args.mode.split(",")
    unknown = set(modes) - set(kind.MODES)
    if unknown:
        raise SystemExit("modes %s are not among the %s kind's %s"
                         % (sorted(unknown), workload["kind"], list(kind.MODES)))
    for mode in modes:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            nums, where = kind.reading(mode, seed, args.seconds, workload, config, device)
            print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                              "numbers": nums, "where": where,
                              "seconds": time.perf_counter() - t}), flush=True)
            _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
