"""Straight-through rounding (port of multimodal_segmentation_tpu/ops/rounding.py
and of ops/pallas_kernels.py::round_ste_pallas).

Binarises the softmax-ed anatomy channels while letting gradients pass
through unchanged (reference layers/rounding.py:8-42). The forward rounds
half to even: the round_ste CUDA kernel (ops/cuda_kernels.py::round_ste)
for a tensor on the GPU, torch.round (the plain version) for a tensor on
the CPU. The device decides; no flag does.
"""

import torch

from multimodal_segmentation_torch.ops.cuda_kernels import round_ste as _round_ste_cuda


class RoundSTE(torch.autograd.Function):
    """Round half to even forward (like jnp.round); identity backward."""

    @staticmethod
    def forward(ctx, x):
        if x.device.type == "cuda":
            return _round_ste_cuda(x.contiguous())
        if x.device.type != "cpu":
            raise ValueError("round_ste runs on 'cuda' or 'cpu', got %s" % x.device)
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x):
    return RoundSTE.apply(x)
