"""infer_volume_ms_p95: 95th percentile of the same latencies."""

from benchmark.harness.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95)
