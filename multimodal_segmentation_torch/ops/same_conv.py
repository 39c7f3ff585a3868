"""A 'same' 3x3x3 convolution (stride 1, zero padding 1) of a bf16 input
with 48 or 96 channels to 48 channels: Swin UNETR's 48-output-channel
convolutions (nn/swin_unetr.py::UnetResBlock, through
nn/unet3d.py::ValidConv3d), seven a window.

Replaces no function of the JAX package. cuDNN runs these shapes in an
sm80 implicit GEMM at 12-19 % of the H100's bf16 peak, whatever engine it
is let choose (PERF.md). same_conv3d is one launch of the same_conv3d CUDA
kernel (ops/cuda_kernels.py::same_conv3d) for a CUDA tensor, an implicit
GEMM on wgmma whose halo bricks TMA brings in, and same_conv3d_plain for a
tensor on the CPU. same_conv3d_plain is the kernel's arithmetic in
PyTorch: for each 16 input channels and each of the 27 taps, the shifted
zero-padded input times that tap's (16, 48) block of the packed weights,
summed in float64 and rounded once to the input's dtype (the kernel sums
in f32, so the two differ by f32's round-off before the rounding). No
bias: the caller adds one as PyTorch adds cuDNN's. While autograd
records, the output carries the convolution's own backward (cuDNN's on
the card).

Both read an (N, C, D, H, W) input and give the (N, 48, D, H, W) output in
channels_last_3d (NDHWC in memory), the layout Swin UNETR's decoder runs
in on the card.
"""

import torch
import torch.nn.functional as F

from multimodal_segmentation_torch.ops.cuda_kernels import same_conv3d as _same_conv3d_cuda

OUT_CHANNELS = 48
IN_CHANNELS = (48, 96)


def pack_weight(weight):
    """The (48, C, 3, 3, 3) weights as the kernel reads them: for each 16
    input channels q and tap t = 9 i + 3 j + l, B's core matrices
    [k // 8][n // 8][n % 8][k % 8] of input channel 16 q + k and output
    channel n; (C // 16, 27, 2, 6, 8, 8), contiguous, in weight's dtype."""
    c = weight.shape[1]
    w = weight.reshape(OUT_CHANNELS // 8, 8, c // 16, 2, 8, 27)
    return w.permute(2, 5, 3, 0, 1, 4).contiguous()


def same_conv3d_plain(x, wp):
    """The same convolution of (N, C, D, H, W) x by the packed weights wp
    as the kernel computes it, in x's dtype and channels_last_3d."""
    n, c, d, h, w = x.shape
    xp = F.pad(x.double(), (1,) * 6)
    b = wp.double().permute(0, 1, 2, 5, 3, 4).reshape(c // 16, 27, 16, OUT_CHANNELS)
    y = torch.zeros(n, d, h, w, OUT_CHANNELS, dtype=torch.float64, device=x.device)
    for q in range(c // 16):
        for t in range(27):
            i, j, l = t // 9, t // 3 % 3, t % 3
            a = xp[:, 16 * q:16 * (q + 1), i:i + d, j:j + h, l:l + w]
            y += torch.einsum("ncdhw,ck->ndhwk", a, b[q, t])
    return y.to(x.dtype).permute(0, 4, 1, 2, 3)


def _forward(x, wp):
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last_3d)
        if x.data_ptr() % 16:
            x = x.clone(memory_format=torch.channels_last_3d)
        return _same_conv3d_cuda(x, wp)
    return same_conv3d_plain(x, wp)


class _SameConv3d(torch.autograd.Function):
    """The forward above; the backward is the convolution's, through
    torch.nn.grad (cuDNN's backward kernels on the card)."""

    @staticmethod
    def forward(ctx, x, weight, wp):
        ctx.save_for_backward(x, weight)
        return _forward(x, wp)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x.shape, weight, g, padding=1)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv3d_weight(x, weight.shape, g, padding=1)
        return gx, gw, None


def same_conv3d(x, weight, wp=None):
    """The same 3x3x3 convolution of (N, C, D, H, W) x by (48, C, 3, 3, 3)
    weight in x's dtype, wp the weights packed (pack_weight; packed here
    when None): the CUDA kernel for a CUDA tensor (bfloat16, C 48 or 96),
    the plain version on the CPU. (N, 48, D, H, W), contiguous in
    channels_last_3d."""
    if wp is None:
        wp = pack_weight(weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _SameConv3d.apply(x, weight, wp)
    return _forward(x, wp)
