"""train_slices_per_s: slices trained in the window over the window's
seconds, host clock; a batch counts once the window's closing
synchronize has found its step done."""


def read(ctx):
    return ctx.slices / ctx.window_s if ctx.latencies_s is None else None
