"""device_idle_share.train: % of the traced window in which nothing ran on
the device."""

from benchmark.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
