"""encode_device_ms.infer: device ms a slice that the program's
`predict.encode` spans own: the anatomy encoders (UNet encoders and B4's rounding)."""

from benchmark.harness.program_spans import device_ms_per_slice


def read(ctx):
    return device_ms_per_slice(ctx, "predict.encode")
