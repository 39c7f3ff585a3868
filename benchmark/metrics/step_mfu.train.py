"""step_mfu.train: % of the H100's bf16 dense peak that the window's
training steps reach, by the reference's FLOP count of a batch."""

from benchmark.harness.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.steps)
