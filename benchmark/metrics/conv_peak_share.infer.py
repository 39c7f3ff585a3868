"""conv_peak_share.infer: the reference's convolution FLOPs of the window
over the device seconds of the kernels filed under convolution, as a %
of the bf16 dense peak."""

from benchmark.harness.readers import conv_peak_share


def read(ctx):
    return conv_peak_share(ctx, ctx.slices)
