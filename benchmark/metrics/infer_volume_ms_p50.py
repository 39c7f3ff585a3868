"""infer_volume_ms_p50: median latency of all studies served in the
window, host arrays in to mask probabilities back on the host."""

from benchmark.harness.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 50)
