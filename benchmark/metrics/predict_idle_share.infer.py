"""predict_idle_share.infer: % of the time inside the program's
`predict_mask` spans of the traced window in which nothing ran on the
device."""

from benchmark.harness.program_spans import idle_share


def read(ctx):
    return idle_share(ctx)
