"""Readings a tile of the program's volumetric spans
(models/volumetric.py::Cardiac3DSegmenter.predict_tiled: the root
`predict_volume` and its children `predict3d.inputs`, `.tiles`, `.net`,
`.stitch`) over the traced window's tiles (the run's `slices`,
harness/infer3d.py), through program_spans. Each returns None where there
is nothing to read: no device trace, or a program that records no such
spans."""

from benchmark.harness.program_spans import attribute, window_spans


def device_ms_per_tile(ctx, names):
    """Device ms that the spans `names` own together, over the window's
    tiles."""
    spans = window_spans(ctx.trace)
    if spans is None or not ctx.slices:
        return None
    owned = attribute(ctx.trace, spans).device_s
    if not any(name in owned for name in names):
        return None
    return 1e3 * sum(owned[name] for name in names) / ctx.slices
