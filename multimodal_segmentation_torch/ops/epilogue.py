"""The eval-mode conv epilogue: a bias-free convolution's output, plus the
conv bias, normalised by a BatchNorm's running statistics and affine, then
ReLU if asked, in the compute dtype.

Replaces no function of the JAX package, whose XLA fuses the same chain
by itself. bn_epilogue is one pass of the bn_epilogue CUDA kernel
(ops/cuda_kernels.py::bn_epilogue), for 4-D tensors on the GPU and 5-D
ones as their 4-D view (the volumetric nets'); its caller,
nn/blocks.py::conv_norm, runs the separate operations on the CPU.
bn_epilogue_plain is those operations as one function: the reference the
tests and chip_smoke.py hold the kernel to, and what the kernel's backward
differentiates. Both round to the dtype after each step as the separate
operations do, so they agree bit for bit.
"""

import torch
import torch.nn.functional as F

from multimodal_segmentation_torch.ops.cuda_kernels import bn_epilogue as _bn_epilogue_cuda


def bn_epilogue_plain(c, conv_bias, mean, var, weight, beta, eps, relu):
    """The epilogue as separate operations in c's dtype: cuDNN's bias add,
    nn/blocks.py::BatchNorm.forward in eval mode ((x - mean) * (rsqrt(var +
    eps) * weight) + bias, the JAX package's order), then F.relu."""
    dt = c.dtype

    def per_channel(t):
        return t.to(dt).view(1, -1, 1, 1)

    x = c + per_channel(conv_bias)
    mul = torch.rsqrt(per_channel(var) + eps) * per_channel(weight)
    y = (x - per_channel(mean)) * mul + per_channel(beta)
    return F.relu(y) if relu else y


class _BNEpilogue(torch.autograd.Function):
    """The kernel forward. The backward recomputes bn_epilogue_plain from
    the saved inputs, whose output is the kernel's bit for bit, and
    differentiates it: the gradients are those of the separate
    operations."""

    @staticmethod
    def forward(ctx, c, conv_bias, mean, var, weight, beta, eps, relu):
        ctx.save_for_backward(c, conv_bias, mean, var, weight, beta)
        ctx.eps, ctx.relu = eps, relu
        return _bn_epilogue_cuda(c, conv_bias, mean, var, weight, beta, eps, relu)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = bn_epilogue_plain(*inputs, ctx.eps, ctx.relu)
        grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def bn_epilogue(c, conv_bias, mean, var, weight, beta, eps, relu):
    """relu?(BatchNorm_eval(c + conv_bias)) in one kernel, for an (N, C, H,
    W) CUDA tensor c, contiguous NCHW or channels_last (another layout
    raises ValueError), or an (N, C, D, H, W) one, passed to the kernel as
    its (N, C, D, H*W) view: contiguous NCDHW or channels_last_3d, whose
    view is NCHW or channels_last, in which each element keeps its
    channel (a 5-D layout with no such view raises ValueError). The
    per-channel arguments are (C,) float32. While autograd records, the
    kernel's output carries the backward above."""
    if c.dim() == 5:
        n, ch, d, h, w = c.shape
        try:
            c4 = c.view(n, ch, d, h * w)
        except RuntimeError:
            raise ValueError("bn_epilogue: an (N, C, D, H, W) c must be contiguous NCDHW or "
                             "channels_last_3d, to be taken as its (N, C, D, H*W) view; got "
                             "strides %s" % (c.stride(),)) from None
        return bn_epilogue(c4, conv_bias, mean, var, weight, beta, eps, relu).view(c.shape)
    args = (c, conv_bias, mean, var, weight, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _BNEpilogue.apply(*args, eps, relu)
    return _bn_epilogue_cuda(*args, eps, relu)
