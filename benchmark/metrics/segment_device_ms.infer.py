"""segment_device_ms.infer: device ms a slice that the program's
`predict.segment` spans own: the segmentor and the output permute."""

from benchmark.harness.program_spans import device_ms_per_slice


def read(ctx):
    return device_ms_per_slice(ctx, "predict.segment")
