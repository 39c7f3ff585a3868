"""data_wait_ms.train: mean ms a step of the traced window spends in
next() on the executor's batch iterator (TrainingData's assembly and
prefetch_to_device): the benchmark's span `data_wait` on the host clock."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans.durations("data_wait")
    return 1e3 * sum(spans) / len(spans) if spans else None
