"""swin_net_device_ms.window3d: device ms a window that the program's
`predict3d.net`, `predict3d.attention` and `predict3d.resblock` spans own
together: Swin UNETR's whole forward over a batch of windows."""

from benchmark.harness.volume_spans import device_ms_per_tile


def read(ctx):
    return device_ms_per_tile(ctx, ("predict3d.net", "predict3d.attention", "predict3d.resblock"))
