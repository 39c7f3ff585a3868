"""The numbers that decide `correct`, each the program's reading against
the reference's. A workload's `checks` name the numbers compared and their
limits; run.py computes and prints those alone, and control.py, which sets
the limits, prints every number here.

Training (one train state driven through its first steps; the reference
follows the first three from the same weights, studies and noise):
  loss_gap            the largest relative gap of the workload's compared
                      losses at the first step, before any update
  grad_gap.<part>     the worst leaf of a part of the model (its top-level
                      module: enc_anatomy, fuser, d_image1, ...; under
                      MMSDNet's Z-regressor's optimizer zreg-<module>): the gap of
                      the first gradient's norm, as the part's optimizer got
                      it (its first moment after the first step over
                      1 - beta1), against the larger of the reference leaf's
                      norm and the median leaf's
  grad_turn.<part>    1 - the cosine between the program's and the
                      reference's first gradient of the part, all its leaves
                      as one vector
  grad_sign.<part>    the share of the part's entries whose first gradient
                      (and so Adam's first update, -lr times its sign) has
                      the other sign, of those whose reference gradient is
                      over ROUND_OFF of the part's largest
  change_gap.<part>   as grad_gap, of the norm of the parameters' change
                      over the three steps
  stats_gap           the worst BatchNorm layer's gap of the running means
                      that the first step leaves (moved once, from the
                      batch's statistics before any update): the norm of
                      their difference over the reference's norm
Leaves whose reference gradient is under ROUND_OFF of the median leaf's
(the balancer under expert pairing: moved by round-off alone) are left
out of the gradient and change gaps; `where` names them.
Inference (a seeded sample of the served studies, the reference run once
over each):
  mask_mismatch   the share of pixels whose most likely class differs
  volume_gap      the largest relative gap of a class's volume (its summed
                  probability) in a study
  region_gap      the largest, over the studies and classes, of the summed
                  absolute gap of the class's probability mass in each block
                  of a REGIONS x REGIONS grid of each slice, over the class's
                  volume: it sees a mask moved, flipped or put on the wrong
                  slice, which keeps every volume
"""

import math
import statistics

import torch

BETA1 = 0.9
ROUND_OFF = 1e-3
REGIONS = 8
# the numbers read from the first step's forward alone
FIRST_STEP = ("loss_gap", "stats_gap")


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def part(leaf):
    """'gen/enc_anatomy.down1.Conv_0.weight' -> 'enc_anatomy',
    'd_mask/d_mask.Dense_0.weight' -> 'd_mask', 'zreg/decoder.Conv_1.bias'
    -> 'zreg-decoder'."""
    opt, name = leaf.split("/", 1)
    module = name.split(".", 1)[0]
    return module if opt in ("gen", module) else opt + "-" + module


def norm_gaps(got, ref):
    """{leaf: |‖got‖ - ‖ref‖| over the larger of ‖ref‖ and the median leaf's
    ‖ref‖}, non-finite gaps as inf."""
    g, r = _norms(got), _norms(ref)
    med = statistics.median(r.values())
    gaps = {k: abs(g[k] - r[k]) / max(r[k], med, 1e-30) for k in ref}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}, g, r


def _by_part(name, gaps, g, r):
    """({name.part: the part's worst gap}, {name.part: [leaf, gap, got, ref]})."""
    worst = {}
    for k, v in gaps.items():
        p = name + "." + part(k)
        if p not in worst or v > gaps[worst[p]]:
            worst[p] = k
    return ({p: gaps[k] for p, k in worst.items()},
            {p: [k, gaps[k], g[k], r[k]] for p, k in worst.items()})


def first_gradients(opt_params, names):
    """{optimizer/parameter: the first moment over 1 - beta1} of each
    optimizer's parameters, cloned."""
    out = {}
    for opt_name, (opt, params) in opt_params.items():
        for p in params:
            # a step that left the state as it was leaves no moment: 0
            m = opt.state[p]["exp_avg"].detach() if p in opt.state else torch.zeros_like(p)
            out["%s/%s" % (opt_name, names[id(p)])] = m / (1 - BETA1)
    return out


def _loss_gap(prog, ref, losses):
    p, r = prog["metrics"][0], ref["metrics"][0]
    gaps = [abs(float(p[k]) - float(r[k])) / max(abs(float(r[k])), 1e-30) for k in losses]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _directions(got, ref, kept):
    """({grad_turn.part: 1 - cosine}, {grad_sign.part: share of entries of
    the other sign}) over each part's kept leaves."""
    turn, sign = {}, {}
    for p in sorted({part(k) for k in kept}):
        leaves = [k for k in kept if part(k) == p]
        a = torch.cat([got[k].double().flatten() for k in leaves])
        b = torch.cat([ref[k].double().flatten() for k in leaves])
        cos = float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))
        turn["grad_turn." + p] = 1.0 - cos if math.isfinite(cos) else math.inf
        big = b.abs() > ROUND_OFF * b.abs().max()
        sign["grad_sign." + p] = float(((a.sign() != b.sign()) & big).sum() / big.sum())
    return turn, sign


def training_numbers(prog, ref, losses):
    """prog, ref: {'metrics': [a dict a step], 'stats': running means after
    the first step} and, for the gradient and change numbers, 'grads':
    first_gradients, 'start' and 'after': {name: tensor}. Returns (numbers,
    where): where holds each part's worst leaf, its norms, each part's
    reference gradient norm and the leaves left out (None without 'grads')."""
    stats = [float(torch.linalg.vector_norm((prog["stats"][k] - v).double())
                   / torch.linalg.vector_norm(v.double()))
             for k, v in ref["stats"].items() if bool(v.abs().max() > 0)]
    numbers = {"loss_gap": _loss_gap(prog, ref, losses),
               "stats_gap": max(stats) if all(math.isfinite(s) for s in stats) else math.inf}
    if "grads" not in prog:
        return numbers, {"left_out": None}
    ref_norms = _norms(ref["grads"])
    med = statistics.median(ref_norms.values())
    kept = [k for k, v in ref_norms.items() if v >= ROUND_OFF * med]
    grads, worst_g = _by_part("grad_gap", *norm_gaps({k: prog["grads"][k] for k in kept},
                                                       {k: ref["grads"][k] for k in kept}))
    moved = sorted({k.split("/", 1)[1] for k in kept})
    changes, worst_c = _by_part("change_gap", *norm_gaps(
        {"gen/" + k: prog["after"][k] - prog["start"][k] for k in moved},
        {"gen/" + k: ref["after"][k] - ref["start"][k] for k in moved}))
    part_norms = {}
    for k, v in ref_norms.items():
        part_norms[part(k)] = math.hypot(part_norms.get(part(k), 0.0), v)
    turn, sign = _directions(prog["grads"], ref["grads"], kept)
    numbers.update(**grads, **turn, **sign, **changes)
    return numbers, {"worst": {**worst_g, **worst_c}, "grad_norm": part_norms,
                     "left_out": sorted(set(ref_norms) - set(kept))}


def inference_numbers(got, ref):
    """got, ref: lists of (n, H, W, C) mask probabilities of the same
    studies; no study at all reads as inf."""
    if not got:
        return dict.fromkeys(("mask_mismatch", "volume_gap", "region_gap"), math.inf)
    diff = total = 0
    volume = region = 0.0
    for g, r in zip(got, ref):
        g, r = torch.as_tensor(g).double(), torch.as_tensor(r).double().to("cpu")
        diff += int((g.argmax(-1) != r.argmax(-1)).sum())
        total += g.shape[0] * g.shape[1] * g.shape[2]
        # each class's volume in the study: its summed probability
        vr = r.sum((0, 1, 2)).clamp(min=1.0)
        volume = max(volume, float(((g.sum((0, 1, 2)) - r.sum((0, 1, 2))).abs() / vr).max()))
        # each class's mass in each block of each slice
        n, h, w, c = g.shape
        blocks = (n, REGIONS, h // REGIONS, REGIONS, w // REGIONS, c)
        mg, mr = g.reshape(blocks).sum((2, 4)), r.reshape(blocks).sum((2, 4))
        region = max(region, float(((mg - mr).abs().sum((0, 1, 2)) / vr).max()))
    return {"mask_mismatch": diff / total, "volume_gap": volume, "region_gap": region}


def verdict(numbers, limits):
    """(correct, {name: {value, limit}}) for the numbers that have a limit;
    a number that the run has none of reads as inf."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
