"""Straight-through rounding (port of multimodal_segmentation_tpu/ops/rounding.py).

Binarises the softmax-ed anatomy channels while letting gradients pass
through unchanged (reference layers/rounding.py:8-42).
"""

import torch


class RoundSTE(torch.autograd.Function):
    """torch.round forward (half to even, like jnp.round); identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x):
    return RoundSTE.apply(x)
