"""resblock_device_ms.window3d: device ms a window that the program's
`predict3d.resblock` spans own: the UnetResBlocks of the convolutional
encoders and decoder (convolutions, InstanceNorms, LeakyReLUs, residual
sums)."""

from benchmark.harness.volume_spans import device_ms_per_tile


def read(ctx):
    return device_ms_per_tile(ctx, ("predict3d.resblock",))
