"""Arithmetic that several metric readers share. Each takes the run's
context (run.py::context) and returns a number, or None where the run
holds nothing to read (no trace, no such kernel in the window)."""

import numpy as np

from benchmark.flops import kernels, peaks


def percentile_ms(ctx, q):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_s), q)) * 1e3


def mfu(ctx, units):
    """% of the bf16 peak: the work's FLOPs (the reference's count a unit)
    over the traced window."""
    if ctx.trace is None or not units:
        return None
    return 100.0 * ctx.flops["total"] * units / (ctx.trace.window_s * peaks.BF16_FLOPS)


def conv_peak_share(ctx, units):
    """% of the bf16 peak that the convolutions' device time reaches on the
    reference's convolution FLOPs."""
    if ctx.trace is None:
        return None
    conv_s = ctx.trace.device_s_of_kind("convolution")
    if conv_s <= 0 or not units:
        return None
    return 100.0 * ctx.flops["conv"] * units / (conv_s * peaks.BF16_FLOPS)


def port_kernels_roofline(ctx):
    """% of the port's kernels' device time that their least time takes,
    over the short shapes profile after the window (ctx.shapes, whose host
    records hold each call's input shapes): the sum over calls of each
    call's bound over the sum of the device time of what the calls
    launched. rotate_group's array list is not in the recorded shapes: its
    bound comes from the workload's rotated channels a batch
    (`rotated_channels`, one entry a call), its device time from its
    calls."""
    if getattr(ctx, "shapes", None) is None:
        return None
    bound = device = rotations = 0.0
    for op, shapes, dtypes, dev_s in ctx.shapes.calls("mmseg_cuda::"):
        if op.endswith("::rotate_group"):
            rotations += dev_s
            continue
        b = kernels.call_bound_s(op, shapes, dtypes)
        if b is not None and dev_s > 0:
            bound += b
            device += dev_s
    channels = ctx.workload.get("rotated_channels")
    if rotations > 0 and channels:
        t = ctx.workload["traffic"]
        bound += ctx.shape_units * sum(kernels.rotation_bound_s(t["batch"], t["hw"], c)
                                       for c in channels)
        device += rotations
    return 100.0 * bound / device if device > 0 else None


def idle_share(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
