"""A valid 3x3x3 convolution, stride 1, of a bf16 input with 1-4 channels
and an even width: the 3D U-Net's first convolution (3 -> 32 channels,
nn/unet3d.py::ValidConv3d).

Replaces no function of the JAX package. With so few input channels cuDNN
runs a legacy kernel without tensor cores, and with the input zero-padded
to 8 or 16 channels an sm80 kernel behind two layout transforms that is
no faster (PERF.md). thin_conv3d is one launch of the thin_conv3d CUDA
kernel (ops/cuda_kernels.py::thin_conv3d) for a CUDA tensor, an implicit
GEMM on the tensor cores whose reduction over the C * 27 taps is
zero-padded to a multiple of 16, and thin_conv3d_plain for a tensor on
the CPU. thin_conv3d_plain is the kernel's arithmetic in PyTorch: the
im2col matrix, zero-padded as the kernel pads it, times the packed
weights, summed in float64 and rounded once to the input's dtype (the
kernel sums in f32, so the two differ by f32's round-off before the
rounding). No bias: the caller adds it as PyTorch adds cuDNN's. While
autograd records, the output carries the convolution's own backward
(cuDNN's on the card).

Both read an (N, C, D, H, W) input and give the (N, K, D - 2, H - 2, W -
2) output in channels_last_3d (NDHWC in memory): on the card the 3D U-Net
runs channels_last_3d from its first convolution on, so that cuDNN's
NDHWC kernels need no layout transform (nn/unet3d.py::UNet3DCicek).
"""

import torch
import torch.nn.functional as F

from multimodal_segmentation_torch.ops.cuda_kernels import thin_conv3d as _thin_conv3d_cuda

MAX_CHANNELS = 4


def pack_weight(weight):
    """The (K, C, 3, 3, 3) weights as the kernel reads them: (K, C * 27)
    rows, zero-padded to ceil(K / 32) * 32 rows of ceil(C * 27 / 16) * 16
    taps, contiguous, in weight's dtype."""
    k, c = weight.shape[:2]
    taps = c * 27
    return F.pad(weight.reshape(k, taps),
                 (0, -taps % 16, 0, -k % 32)).contiguous()


def thin_conv3d_plain(x, weight):
    """The valid 3x3x3 convolution of (N, C, D, H, W) x by (K, C, 3, 3, 3)
    weight as the kernel computes it, in x's dtype and channels_last_3d."""
    n, c, d, h, w = x.shape
    k = weight.shape[0]
    cols = x.unfold(2, 3, 1).unfold(3, 3, 1).unfold(4, 3, 1)
    cols = cols.permute(0, 2, 3, 4, 1, 5, 6, 7).reshape(n, -1, c * 27)
    cols = F.pad(cols.double(), (0, -(c * 27) % 16))
    wp = pack_weight(weight).double()[:k]
    y = (cols @ wp.T).to(x.dtype).view(n, d - 2, h - 2, w - 2, k)
    return y.permute(0, 4, 1, 2, 3)


def _forward(x, weight):
    if x.is_cuda:
        x = x.contiguous()
        if x.data_ptr() % 4:
            x = x.clone()
        return _thin_conv3d_cuda(x, pack_weight(weight), weight.shape[0])
    return thin_conv3d_plain(x, weight)


class _ThinConv3d(torch.autograd.Function):
    """The forward above; the backward is the convolution's, through
    torch.nn.grad (cuDNN's backward kernels on the card)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _forward(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x.shape, weight, g)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv3d_weight(x, weight.shape, g)
        return gx, gw


def thin_conv3d(x, weight):
    """The valid 3x3x3 convolution of (N, C, D, H, W) x by (K, C, 3, 3, 3)
    weight in x's dtype: the CUDA kernel for a CUDA tensor (bfloat16, C <=
    MAX_CHANNELS, W even), the plain version on the CPU. (N, K, D - 2, H -
    2, W - 2), contiguous in channels_last_3d."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _ThinConv3d.apply(x, weight)
    return _forward(x, weight)
