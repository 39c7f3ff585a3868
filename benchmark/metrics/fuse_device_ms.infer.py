"""fuse_device_ms.infer: device ms a slice that the program's
`predict.fuse` spans own: the fuser (LocNet, TPS flow and B1)."""

from benchmark.harness.program_spans import device_ms_per_slice


def read(ctx):
    return device_ms_per_slice(ctx, "predict.fuse")
