"""net3d_device_ms.infer3d: device ms a tile that the program's
`predict3d.net` spans own: the 3D U-Net's forward over a batch of tiles
(cuDNN convolutions, the eval-mode conv epilogue, pools, concatenations,
the softmax)."""

from benchmark.harness.volume_spans import device_ms_per_tile


def read(ctx):
    return device_ms_per_tile(ctx, ("predict3d.net",))
