"""port_kernels_roofline.train: the port's kernels B1-B4 (mmseg_cuda
operators): the sum of each call's least time over the sum of their
device time, %."""

from benchmark.harness.readers import port_kernels_roofline


def read(ctx):
    return port_kernels_roofline(ctx)
