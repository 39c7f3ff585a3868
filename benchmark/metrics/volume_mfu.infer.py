"""volume_mfu.infer: % of the H100's bf16 dense peak that the window's
served slices reach, by the reference's FLOP count of a slice."""

from benchmark.harness.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.slices)
