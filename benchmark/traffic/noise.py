"""The random inputs of a training step, drawn from the benchmark's own
generator on the device and handed to the program and to the reference
alike.

A workload file describes each kind of noise as a list of parts:
  {"name": "angles", "draw": "angle", "count": 3}     3 x (B,) radians,
                                                       uniform in
                                                       [-range, range) deg
  {"name": "gen_eps", "draw": "normal", "rows": 2}    (2B, num_z) N(0, 1)
  {"name": "pool_idx", "draw": "slot", "slots": 4}    (B,) integers in [0, 4)
"count" makes the part a list of that many draws; "rows" multiplies the
batch (default 1).
"""

import math

import torch


def draw(parts, generator, batch, num_z, rotation_range):
    dev = generator.device

    def one(part):
        rows = batch * part.get("rows", 1)
        kind = part["draw"]
        if kind == "angle":
            u = torch.rand(rows, generator=generator, device=dev)
            return (u * (2.0 * rotation_range) - rotation_range) * (math.pi / 180.0)
        if kind == "normal":
            return torch.randn((rows, num_z), generator=generator, device=dev)
        if kind == "slot":
            return torch.randint(0, part["slots"], (rows,), generator=generator, device=dev)
        raise ValueError("unknown noise draw %r" % kind)

    out = {}
    for part in parts:
        if "count" in part:
            out[part["name"]] = [one(part) for _ in range(part["count"])]
        else:
            out[part["name"]] = one(part)
    return out
