"""tiling_device_ms.infer3d: device ms a tile that the program's
overlap-tile spans own together: `predict3d.inputs` (the volume's copy to
the device and its mirror padding), `.tiles` (gathering each batch of
tiles) and `.stitch` (placing the outputs, the crop)."""

from benchmark.harness.volume_spans import device_ms_per_tile


def read(ctx):
    return device_ms_per_tile(ctx, ("predict3d.inputs", "predict3d.tiles", "predict3d.stitch"))
