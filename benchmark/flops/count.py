"""Counts the operations of a cell's work on the plain reference, at the
cell's shapes, on the meta device (no data, no time): one training batch
(the workload's step calls) or one served slice. FLOPs are 2 a
multiply-add, as torch.utils.flop_counter counts them; `conv` is the part
in convolutions (forward and backward). Optimizer updates are not counted.

    python benchmark/flops/count.py dafnet_chaos

prints, for each workload of that configuration, the counts that its
configuration file keeps under `flops`.
"""

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402
from benchmark.reference import models, train  # noqa: E402
from benchmark.traffic import noise as noise_mod  # noqa: E402

CONV_OPS = ("convolution", "convolution_backward")


def _split(counter):
    counts = counter.get_flop_counts().get("Global", {})
    total = sum(counts.values())
    conv = sum(v for k, v in counts.items() if str(k).split(".")[-1] in CONV_OPS)
    return {"total": int(total), "conv": int(conv)}


def train_batch(conf, workload):
    """One batch of the workload's step calls on meta tensors."""
    dev = torch.device("meta")
    trainer = train.Trainer(conf, None, dev)
    train._adam_step = lambda opt, params, grads: None
    B, (H, W) = conf.batch_size, conf.input_hw
    K = conf.n_pairs if conf.automatedpairing else 1
    nm = conf.num_masks
    x1, x2 = ("x1_pairs", "x2_pairs") if conf.automatedpairing else ("x1", "x2")
    shapes = {x1: (B, H, W, K), x2: (B, H, W, K), "m1": (B, H, W, nm), "m2": (B, H, W, nm),
              "dm1": (B, H, W, nm), "dm2": (B, H, W, nm), "dx1": (B, H, W, 1),
              "dx2": (B, H, W, 1), "dm": (B, H, W, nm)}
    batch = {k: torch.zeros(v, device=dev) for k, v in shapes.items()}
    parts = {"sup": batch, "unsup": batch, "disc": batch}
    gen = torch.Generator(device="cpu")
    with FlopCounterMode(display=False) as counter:
        for method, part, kind in workload["steps"]:
            nz = noise_mod.draw(workload["noise"][kind], gen, B, conf.num_z, conf.rotation_range)
            nz = {k: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
                  for k, v in nz.items()}
            getattr(trainer, method)({k: v for k, v in parts[part].items()}, nz)
    return _split(counter)


def served_slice(conf, workload):
    """predict_mask over one slice on meta tensors."""
    dev = torch.device("meta")
    with torch.device("meta"):
        model = models.MODELS[conf.model](conf).eval()
    H, W = conf.input_hw
    x = torch.zeros((1, H, W, 1), device=dev)
    with FlopCounterMode(display=False) as counter:
        model.predict_mask(workload["traffic"]["modality_index"], [x, x])
    return _split(counter)


def main(argv):
    name = argv[0]
    bench = common.load_json(os.path.join(common.REPO, "BENCHMARK.json"))
    config = common.load_json(os.path.join(common.BENCH_DIR, "configs", name + ".json"))
    out = {}
    for w in bench["workloads"]:
        if w["config"] != name:
            continue
        wl = common.load_json(os.path.join(common.BENCH_DIR, "workloads", w["name"] + ".json"))
        c = common.namespace(common.model_fields(config, wl, 0))
        key = wl["flops"]
        out[key] = train_batch(c, wl) if wl["kind"] == "train" else served_slice(c, wl)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
