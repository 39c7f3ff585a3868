"""swin_attention_device_ms.window3d: device ms a window that the
program's `predict3d.attention` spans own: each Swin block's attention
half, from its first LayerNorm to the crop of its padded windows."""

from benchmark.harness.volume_spans import device_ms_per_tile


def read(ctx):
    return device_ms_per_tile(ctx, ("predict3d.attention",))
